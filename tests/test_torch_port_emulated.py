"""The CUDA kernels' own source, run on the CPU through an emulator.

A CUDA kernel has no interpret mode, and the CPU test run has no
``nvcc`` and no card, so the plain-version tests never reach a kernel's
indexing.
This file compiles ``ops/csrc/flash_fwd.cu``, ``flash_bwd.cu`` and
``paged_attention.cu`` with g++ against a small emulation of what they
use, and holds the kernels (bf16 tensor-core K1, K2 and K3, the scalar
f32 kernels, K4's split and combine kernels) against their plain
versions on seeded inputs:

* one ``std::thread`` per CUDA thread of a block, blocks in turn;
  ``std::barrier`` for ``__syncthreads`` and for warp-synchronous steps;
* warp-wide exchange for ``__shfl_xor_sync``, ``ldmatrix`` (``.trans``
  too) and ``mma.sync.m16n8k16`` bf16, by the PTX ISA's fragment
  layouts (the asm primitives of ``mma_bf16.cuh`` are swapped for these;
  its addressing and tile loaders are compiled as they are);
* ``cp.async`` landing at once, or only at ``cp.async.wait_group``
  (both are run: a read before its wait, or a write into a buffer still
  being read, breaks one of them); shared memory starts as NaN bytes.

What it cannot show: that nvcc accepts the source, the asm strings
themselves, timing, or races between warps that the barriers order
here.  Those are the card's (``chip_smoke.py``,
``tests/test_torch_port_cuda.py``).  The kernels run in a child process
under a time limit, so a kernel whose warps diverge at a barrier fails
the test instead of hanging it.

Tolerances as on the card: K1 5e-2 (bf16) and 1e-4 (f32) absolute;
K2/K3 2e-2 (bf16) and 1e-4 (f32) of the largest gradient; K4 1e-4 (f32
and int8 -> f32) and 2e-2 (bf16 and int8 -> bf16) absolute.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "horovod_tpu_torch" / "ops" / "csrc"

EMU_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_idx { unsigned x, y, z; };
inline thread_local emu_idx threadIdx, blockIdx;
inline dim3 gridDim, blockDim;

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid value" : "no error";
}

struct __nv_bfloat16 { uint16_t x; };
inline __nv_bfloat16 __float2bfloat16(float f) {  // nearest even
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  return {uint16_t((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.x) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}

struct EmuCopy { void* dst; const void* src; int n, size; };
struct EmuBlock {
  std::vector<unsigned char> smem;
  std::barrier<>* bar;
  std::vector<std::barrier<>*> warp_bar;
  std::vector<uint64_t> xchg;  // 8 words a lane
};
inline thread_local EmuBlock* emu_blk;
inline thread_local std::vector<EmuCopy> emu_open;
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;
inline int emu_copies_at_wait = 0;

[[noreturn]] inline void emu_fail(const char* what, const void* p) {
  fprintf(stderr, "emulated kernel fault: %s %p\n", what, p);
  abort();
}
inline unsigned char* emu_smem() { return emu_blk->smem.data(); }
inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline int emu_lane() { return threadIdx.x & 31; }
inline uint64_t* emu_x(int lane) {
  return &emu_blk->xchg[((threadIdx.x >> 5) * 32 + lane) * 8];
}
inline void emu_warp_sync() {
  emu_blk->warp_bar[threadIdx.x >> 5]->arrive_and_wait();
}
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_sync(); }
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  memcpy(emu_x(emu_lane()), &v, 4);
  emu_warp_sync();
  float r;
  memcpy(&r, emu_x(emu_lane() ^ mask), 4);
  emu_warp_sync();
  return r;
}
inline bool emu_in_smem(const void* p, size_t n) {
  const auto* b = emu_blk->smem.data();
  const auto* c = static_cast<const unsigned char*>(p);
  return c >= b && c + n <= b + emu_blk->smem.size();
}
inline void emu_land(const EmuCopy& c) {
  memcpy(c.dst, c.src, c.n);
  memset(static_cast<char*>(c.dst) + c.n, 0, c.size - c.n);
}
inline void emu_cp(void* dst, const void* src, int size, int n) {
  if (!emu_in_smem(dst, size) || (uintptr_t)dst % size)
    emu_fail("cp.async dst", dst);
  if ((uintptr_t)src % size || n < 0 || n > size)
    emu_fail("cp.async src", src);
  if (emu_copies_at_wait) emu_open.push_back({dst, src, n, size});
  else emu_land({dst, src, n, size});
}
inline void emu_commit() {
  emu_groups.push_back(emu_open);
  emu_open.clear();
}
inline void emu_wait(int newest_in_flight) {
  while ((int)emu_groups.size() > newest_in_flight) {
    for (const auto& c : emu_groups.front()) emu_land(c);
    emu_groups.erase(emu_groups.begin());
  }
}
inline float emu_bf(uint32_t h) {
  uint32_t u = h << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
// ldmatrix .x4: lane i gives the row address of matrix i / 8; register
// r of a lane holds matrix r's row lane / 4, columns 2 (lane % 4) + 0, 1
// (.trans: rows 2 (lane % 4) + 0, 1 of column lane / 4).
inline void emu_ldsm(uint32_t (&r)[4], const void* p, bool trans) {
  if (!emu_in_smem(p, 16) || (uintptr_t)p % 16) emu_fail("ldmatrix", p);
  const int lane = emu_lane();
  emu_x(lane)[7] = (uint64_t)p;
  emu_warp_sync();
  for (int m = 0; m < 4; ++m) {
    uint32_t h[2];
    for (int e = 0; e < 2; ++e) {
      const int src = trans ? 8 * m + 2 * (lane & 3) + e : 8 * m + (lane >> 2);
      const int col = trans ? lane >> 2 : 2 * (lane & 3) + e;
      h[e] = ((const uint16_t*)emu_x(src)[7])[col];
    }
    r[m] = h[0] | (h[1] << 16);
  }
  emu_warp_sync();
}
// mma.m16n8k16 row.col bf16 -> f32, g = lane / 4, t = lane % 4:
// A a0 (g, 2t..) a1 (g+8, 2t..) a2 (g, 2t+8..) a3 (g+8, 2t+8..);
// B b0 (k 2t.., n g) b1 (k 2t+8.., n g); C c0 c1 (g, 2t..) c2 c3 (g+8, ..).
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                    uint32_t b1) {
  const int lane = emu_lane();
  uint64_t* x = emu_x(lane);
  for (int i = 0; i < 4; ++i) x[i] = a[i];
  x[4] = b0;
  x[5] = b1;
  emu_warp_sync();
  auto half = [](uint64_t w, int hi) {
    return uint32_t(w >> (16 * hi)) & 0xffffu;
  };
  auto A = [&](int r, int k) {
    const uint64_t w = emu_x((r % 8) * 4 + (k % 8) / 2)[(r >= 8) + 2 * (k >= 8)];
    return emu_bf(half(w, k & 1));
  };
  auto B = [&](int k, int n) {
    return emu_bf(half(emu_x(n * 4 + (k % 8) / 2)[4 + (k >= 8)], k & 1));
  };
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int row = (lane >> 2) + 8 * (e >= 2), col = 2 * (lane & 3) + (e & 1);
    float acc = d[e];
    for (int k = 0; k < 16; ++k) acc += A(row, k) * B(k, col);
    out[e] = acc;
  }
  emu_warp_sync();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}

template <class... P, class... Arg>
void emu_launch(void (*kern)(P...), dim3 grid, int threads, size_t smem,
                cudaStream_t, Arg... args) {
  if (const char* m = getenv("EMU_COPIES_AT_WAIT"))
    emu_copies_at_wait = atoi(m);
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned xb = 0; xb < grid.x; ++xb) {
        EmuBlock blk;
        blk.smem.assign(smem, 0xFF);  // unwritten shared memory is NaN
        std::barrier<> bar(threads);
        blk.bar = &bar;
        std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
        for (int w = 0; w < threads / 32; ++w) {
          warp_bars.push_back(std::make_unique<std::barrier<>>(32));
          blk.warp_bar.push_back(warp_bars.back().get());
        }
        blk.xchg.assign(threads * 8, 0);
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([&, t] {
            emu_blk = &blk;
            threadIdx = {unsigned(t), 0, 0};
            blockIdx = {xb, y, z};
            emu_open.clear();
            emu_groups.clear();
            kern(args...);
            for (const auto& g : emu_groups)
              if (!g.empty()) emu_fail("cp.async never waited for", nullptr);
          });
        for (auto& th : ts) th.join();
      }
}
"""

# The asm primitives of mma_bf16.cuh, as calls into the emulator.
PRIMITIVES = """
inline void cp_async16(void* d, const void* s, int n) { emu_cp(d, s, 16, n); }
inline void cp_async4(void* d, const void* s, int n) { emu_cp(d, s, 4, n); }
inline void cp_async_commit() { emu_commit(); }
template <int N> inline void cp_async_wait() { emu_wait(N); }
inline void ldsm_x4(uint32_t (&r)[4], const bf16* p) { emu_ldsm(r, p, false); }
inline void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  emu_ldsm(r, p, true);
}
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                     uint32_t b1) {
  emu_mma(d, a, b0, b1);
}
"""


def _emulated_source(text: str) -> str:
    """A kernel source as host C++: dynamic shared memory from the
    emulated block, ``<<<...>>>`` launches as ``emu_launch`` calls."""
    text = re.sub(r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
                  r"unsigned char* \1 = emu_smem();", text)
    text = re.sub(r"extern __shared__ float (\w+)\[\];",
                  r"float* \1 = reinterpret_cast<float*>(emu_smem());", text)
    return re.sub(r"(\w+)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ", text)


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    """``libflash_fwd.so``, ``libflash_bwd.so`` and
    ``libpaged_attention.so`` built by g++ from the repository's sources
    under the emulator."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ with C++20 to build the emulated kernels")
    out = tmp_path_factory.mktemp("emulated")
    (out / "emu.h").write_text(EMU_H)
    for shim in ("cuda_runtime.h", "cuda_bf16.h"):
        (out / shim).write_text('#pragma once\n#include "emu.h"\n')
    header = (CSRC / "mma_bf16.cuh").read_text()
    start = header.index("__device__ __forceinline__ uint32_t smem_u32")
    end = header.index("// Two f32 values rounded")
    (out / "mma_bf16.cuh").write_text(header[:start] + PRIMITIVES
                                      + header[end:])
    procs = []
    for name in ("flash_fwd", "flash_bwd", "paged_attention"):
        src = out / f"{name}.cpp"
        src.write_text(_emulated_source((CSRC / f"{name}.cu").read_text()))
        procs.append(subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-Wno-unknown-pragmas", "-I", str(out), "-include", "emu.h",
             "-o", str(out / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log
    return out


# Runs in a child process: loads the emulated libraries through the same
# C entry points the wrappers bind, prints one JSON line of errors.
CHILD = r"""
import ctypes, json, math, sys
import torch
from horovod_tpu_torch.ops import attention as A

libdir, dtype = sys.argv[1], {"bf16": torch.bfloat16, "f32": torch.float32}[sys.argv[2]]
fwd = ctypes.CDLL(f"{libdir}/libflash_fwd.so")
bwd = ctypes.CDLL(f"{libdir}/libflash_bwd.so")

def ptr(t):
    return ctypes.c_void_p(t.data_ptr())

def call(lib, name, n_ptr, tensors, *dims):
    rc = A._bind(lib, name, n_ptr)(*map(ptr, tensors), *dims, None)
    assert rc == 0, (name, rc)

torch.set_num_threads(1)
res = {}
for i, (B, H, Hkv, S, T, D, shift) in enumerate(json.loads(sys.argv[3])):
    g = torch.Generator().manual_seed(i)
    q, k, v, do = (torch.randn(s, generator=g).to(dtype) for s in (
        (B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D), (B, H, S, D)))
    scale = 1 / math.sqrt(D)
    dims = (B, H, Hkv, S, T, D, int(dtype == torch.bfloat16),
            *A._mask_args(shift, S, T), scale)
    o, lse = torch.empty_like(q), torch.empty((B, H, S))
    call(fwd, "flash_fwd", 5, (q, k, v, o, lse), *dims)
    o_r, lse_r = A._reference_attention_lse(
        q, A.expand_kv(k, H), A.expand_kv(v, H), shift, scale)
    delta = (do.float() * o_r.float()).sum(-1) - 0.25
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    call(bwd, "flash_bwd_dkdv", 8, (q, k, v, do, lse_r, delta, dk, dv), *dims)
    call(bwd, "flash_bwd_dq", 7, (q, k, v, do, lse_r, delta, dq), *dims)
    rk, rv = A._flash_bwd_dkdv_reference(q, k, v, do, lse_r, delta, shift,
                                         scale)
    rq = A._flash_bwd_dq_reference(q, k, v, do, lse_r, delta, shift, scale)

    def rel(a, b):
        b = b.float()
        return ((a.float() - b).abs().max() / b.abs().max().clamp_min(1)).item()

    res[str([B, H, Hkv, S, T, D, shift])] = {
        "o": (o.float() - o_r.float()).abs().max().item(),
        "lse": (lse - lse_r).abs().max().item(),
        "dk": rel(dk, rk), "dv": rel(dv, rv), "dq": rel(dq, rq)}
print(json.dumps(res))
"""

# (B, H, H_kv, S, T, D, shift): tile-aligned and ragged S, GQA, both
# head dims, S != T unmasked / bottom-right causal / fully masked, a
# shifted diagonal that leaves the first rows fully masked, one query
# row, and D = 128 with GQA and a ragged S.
CASES = [(1, 2, 2, 64, 64, 64, 0), (1, 4, 1, 130, 130, 64, 0),
         (1, 2, 2, 17, 17, 128, None), (1, 2, 2, 100, 300, 64, -200),
         (1, 2, 2, 100, 300, 64, 200), (1, 2, 1, 150, 150, 128, 50),
         (1, 2, 2, 1, 1, 64, 0), (1, 4, 2, 77, 77, 128, 0)]


@pytest.mark.parametrize("copies", ["immediate", "at_wait"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_emulated_kernels_match_plain_versions(emulated_libs, dtype, copies):
    env = dict(os.environ, PYTHONPATH=str(REPO),
               EMU_COPIES_AT_WAIT=str(int(copies == "at_wait")))
    run = subprocess.run(
        [sys.executable, "-c", CHILD, str(emulated_libs), dtype,
         json.dumps(CASES)], capture_output=True, text=True, timeout=300,
        env=env)
    assert run.returncode == 0, run.stderr[-4000:]
    res = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(res) == len(CASES)
    fwd_tol, bwd_tol = (5e-2, 2e-2) if dtype == "bf16" else (1e-4, 1e-4)
    for case, err in res.items():
        assert err["o"] <= fwd_tol and err["lse"] <= fwd_tol, (case, err)
        assert max(err["dk"], err["dv"], err["dq"]) <= bwd_tol, (case, err)


# K4 through the same C entry point the wrapper binds, with the pages a
# split chosen by the case, so that split edges fall where the table
# needs them.
PAGED_CHILD = r"""
import ctypes, json, math, sys
import numpy as np
import torch
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import paged_attention as PA

libdir, pool = sys.argv[1], sys.argv[2]
lib = ctypes.CDLL(f"{libdir}/libpaged_attention.so")
fn = lib.paged_attend
fn.restype = ctypes.c_int
fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
               + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_int])
kind, compute = {"f32": (0, torch.float32), "bf16": (1, torch.bfloat16),
                 "int8_f32": (2, torch.float32),
                 "int8_bf16": (2, torch.bfloat16)}[pool]

def ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None

torch.set_num_threads(1)
res = []
for i, case in enumerate(json.loads(sys.argv[3])):
    Hkv, R, Dh, ps, pps = (case[k] for k in ("Hkv", "R", "Dh", "ps", "pps"))
    limit = np.asarray(case["limit"], np.int32)
    S, MP, Pn = len(limit), case["MP"], case["pages"]
    rng = np.random.RandomState(i)
    qg = torch.from_numpy(rng.randn(S, Hkv, R, Dh).astype(np.float32))
    if case.get("q_bf16"):
        qg = qg.to(torch.bfloat16)
    kf = torch.from_numpy(rng.randn(Pn, Hkv, ps, Dh).astype(np.float32))
    vf = torch.from_numpy(rng.randn(Pn, Hkv, ps, Dh).astype(np.float32))
    table = rng.permutation(np.arange(1, Pn))[:S * MP].reshape(S, MP)
    for a, b in case.get("share", []):
        table[b] = table[a]                  # two slots, the same pages
    table = torch.from_numpy(np.ascontiguousarray(table, np.int32))
    if kind == 2:
        (kp, ks), (vp, vs) = T.kv_quantize(kf), T.kv_quantize(vf)
    else:
        kp, vp, ks, vs = kf.to(compute), vf.to(compute), None, None
    lim = torch.from_numpy(limit)
    n_split = -(-MP // pps)
    o, lse = torch.empty(S, Hkv, R, Dh), torch.empty(S, Hkv, R)
    part = torch.empty(S * Hkv * n_split * R * (Dh + 2))
    rc = fn(ptr(qg), ptr(kp), ptr(vp), ptr(ks), ptr(vs), ptr(table),
            ptr(lim), ptr(o), ptr(lse), S, Hkv, R, Dh, ps, MP, kind,
            int(compute == torch.bfloat16), math.sqrt(Dh), None, ptr(part),
            pps, int(qg.dtype == torch.bfloat16))
    assert rc == 0, (case, rc)
    o_r, l_r = PA.paged_attend_reference(qg, kp, vp, ks, vs, table, lim,
                                         compute_dtype=compute)
    live = lim > 0
    res.append({"o": (o - o_r).abs().max().item(),
                "lse": (lse[live] - l_r[live]).abs().max().item(),
                "dead_o": o[~live].abs().max().item() if (~live).any() else 0,
                "dead_lse": lse[~live].max().item() if (~live).any()
                else PA.NEG_INF})
print(json.dumps(res))
"""

# Each case: kv heads, query rows R, head dim, page size, pages a split
# (pps), table width MP, pool pages, slot limits, slots sharing a table
# row.  The first covers a limit = 0 slot, a slot at table capacity, a
# limit exactly on a split boundary (32 = 2 pages of 16, pps 2) and one
# position past it, a partial last page with splits wholly past the
# limit, and two slots sharing their pages; the others R = 1 at
# Dh = 128 with q in bf16, R = 8 on pages of 8, and R = 12 (two R
# blocks) at Dh = 96 (idle lanes) on pages of 40 rows (ring chunks of 64
# rows that cross a page boundary).
PAGED_CASES = [
    dict(Hkv=2, R=4, Dh=64, ps=16, pps=2, MP=6, pages=40,
         limit=[0, 96, 32, 33, 5, 50], share=[[1, 5]]),
    dict(Hkv=2, R=1, Dh=128, ps=16, pps=3, MP=4, pages=13,
         limit=[64, 49, 0], q_bf16=True),
    dict(Hkv=2, R=8, Dh=64, ps=8, pps=2, MP=5, pages=16, limit=[40, 17, 16]),
    dict(Hkv=1, R=12, Dh=96, ps=40, pps=2, MP=3, pages=7, limit=[120, 70]),
]


@pytest.mark.parametrize("copies", ["immediate", "at_wait"])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8_f32", "int8_bf16"])
def test_emulated_paged_kernel_matches_plain_version(emulated_libs, pool,
                                                     copies):
    env = dict(os.environ, PYTHONPATH=str(REPO),
               EMU_COPIES_AT_WAIT=str(int(copies == "at_wait")))
    run = subprocess.run(
        [sys.executable, "-c", PAGED_CHILD, str(emulated_libs), pool,
         json.dumps(PAGED_CASES)], capture_output=True, text=True,
        timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-4000:]
    res = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(res) == len(PAGED_CASES)
    tol = 2e-2 if pool.endswith("bf16") else 1e-4
    for case, err in zip(PAGED_CASES, res):
        assert err["o"] <= tol and err["lse"] <= tol, (case, err)
        assert err["dead_o"] == 0 and err["dead_lse"] <= -1e30 / 2, (case,
                                                                     err)
