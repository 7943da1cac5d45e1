"""The CUDA kernels' own source, run on the CPU through an emulator: the
shared harness of ``tests/test_torch_port_emulated_*.py``.

A CUDA kernel has no interpret mode, and the CPU test run has no
``nvcc`` and no card, so the plain-version tests never reach a kernel's
indexing.
Those files compile ``ops/csrc/flash_fwd.cu``, ``flash_bwd.cu``,
``paged_attention.cu`` and ``grouped_matmul.cu`` with g++ against a
small emulation of what they use (:func:`build`, each file only the
sources it runs), and hold the kernels (the bf16 K1, K2 and K3 on
wgmma + TMA and in f32 register-tiled and fed by cp.async, K4's split,
rows (mma.sync fed by TMA) and combine kernels, G1's wgmma + TMA and
register-tiled f32 kernels in both modes, G2's wgmma + TMA and
register-tiled f32 kernels) against
their plain versions on seeded inputs (K1 also with its shift read from
memory; K1, K2 and K3 also bit for bit against themselves in a second
call; G1 also bit for bit against itself in another batch; G2 also bit
for bit against itself in a second call):

* one ``std::thread`` per CUDA thread of a block, blocks in turn;
  ``std::barrier`` for ``__syncthreads`` and for warp-synchronous steps;
* warp-wide exchange for ``__shfl_xor_sync``, ``ldmatrix`` (``.trans``
  too) and ``mma.sync.m16n8k16`` bf16, by the PTX ISA's fragment
  layouts (the asm primitives of ``mma_bf16.cuh`` are swapped for these;
  its addressing and tile loaders are compiled as they are);
* ``cp.async`` landing at once, or only at ``cp.async.wait_group``
  (both are run: a read before its wait, or a write into a buffer still
  being read, breaks one of them); shared memory starts as NaN bytes;
* Hopper (``wgmma_tma.cuh``'s asm primitives swapped likewise):
  mbarriers with arrival counts, transaction bytes and phase parity
  (a wait that never completes fails after 60 s); ``cuTensorMapEncodeTiled``
  with the driver's rules on alignment, strides and box sizes; TMA's box
  copy, zero past every edge, 128-byte swizzled by the PTX ISA's pattern
  (bits 4-6 of the offset XOR bits 7-9); ``wgmma.m64nNk16`` at N = 64
  and 128 reading B, and A in the shared-memory form, through their
  descriptors by the canonical K-major and MN-major layouts (each by its
  own transpose bit), A in the register form from the warp's lanes by
  mma.sync's A fragment layout, and writing its accumulator fragment;
  TMA tiles and wgmma products land at issue, or at their barrier's
  wait and their group's ``wgmma.wait_group`` (a register-form product
  reads its A registers then too, so a kernel that overwrites them
  before the wait fails in that mode); fence, commit and wait are warp
  barriers, as ``.sync.aligned`` makes them on the card; named barriers
  (``bar.sync id, n`` waits, ``bar.arrive id, n`` only arrives) are
  barriers of n threads; ``ex2.approx.ftz`` is
  ``exp2f``.

What it cannot show: that nvcc accepts the source, the asm strings
themselves, timing, or races between warps that the barriers order
here; for Hopper, the proxies (generic writes that wgmma reads need
``fence.proxy.async``: the emulator has one memory, so a missing fence
shows only on the card), that the descriptor bits, the canonical layouts,
the register fragment and the swizzle it decodes are the hardware's (the
kernel and the emulator share one reading of the PTX ISA: the card's
tests and ``chip_smoke.py``'s ``kernel_checks`` and ``grouped_kernel``
phases are what hold it), the tensor cores' own summation order within
a k-step, the TMA unit's and wgmma's asynchrony beyond the two landing
points, and what ptxas makes of the waits (it serialises every wgmma of
a kernel whose waits it cannot prove uniform: ``chip_smoke.py``'s times
show that).  Those are the card's (``chip_smoke.py``,
``tests/test_torch_port_cuda.py``).  The kernels run in a child process
under a time limit (:func:`run_child`), so a kernel whose warps diverge
at a barrier fails the test instead of hanging it.  The flash, paged
and grouped files also hold ``chip_smoke.py``'s names for K1-K4 and the
grouped kernels (what its SASS check keys on) against the built
library's symbols.

Tolerances as on the card: K1 5e-2 (bf16) and 1e-4 (f32) absolute;
K2/K3 2e-2 (bf16) and 1e-4 (f32) of the largest gradient; K4 1e-4 (f32
and int8 -> f32) and 2e-2 (bf16 and int8 -> bf16) absolute; G1 and
G2 2e-2 (bf16) and 1e-4 (f32) of the largest output.
"""

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
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
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
struct alignas(8) float2 { float x, y; };
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}

struct EmuCopy { void* dst; const void* src; int n, size; };
struct EmuLanding { unsigned char* dst; std::vector<unsigned char> bytes; };
// An mbarrier: arrivals still owed this phase, bytes still to land (tx),
// the parity of the phase in progress, and (copies at wait) the TMA
// tiles that land when a thread waits on the completed phase.
struct EmuMbar {
  int count = 0, pending = 0, phase = 0;
  long tx = 0, deferred_bytes = 0;
  std::vector<EmuLanding> deferred;
};
struct EmuBlock {
  std::vector<unsigned char> smem;
  std::barrier<>* bar;
  std::vector<std::barrier<>*> warp_bar;
  std::vector<uint64_t> xchg;  // 8 words a lane
  std::mutex mu;               // guards mbars
  std::condition_variable cv;
  std::map<const void*, EmuMbar> mbars;
  std::map<int, std::unique_ptr<std::barrier<>>> named;  // bar.sync id
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
// Named barrier id of n threads, made at its first use.
inline std::barrier<>* emu_named(int id, int threads) {
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  auto& slot = emu_blk->named[id];
  if (id < 1 || id > 15 || threads % 32) emu_fail("named barrier", nullptr);
  if (!slot) slot = std::make_unique<std::barrier<>>(threads);
  return slot.get();
}
// bar.sync id, n: arrive and wait; bar.arrive id, n: arrive only.
inline void emu_named_barrier(int id, int threads) {
  emu_named(id, threads)->arrive_and_wait();
}
inline void emu_named_barrier_arrive(int id, int threads) {
  (void)emu_named(id, threads)->arrive();
}
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

// --- Hopper: tensor maps, mbarriers, TMA, wgmma ----------------------------

#define __grid_constant__
#define CUDART_VERSION 12080
typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
enum CUresult { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0,
                          CU_TENSOR_MAP_SWIZZLE_128B = 3 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
struct alignas(64) CUtensorMap { uint64_t opaque[16]; };
// What the emulated driver keeps in a tensor map's opaque bytes.
struct EmuTmap {
  const unsigned char* base;
  int rank, swizzle;
  uint64_t dims[5], strides[5];  // strides in bytes, strides[0] the element
  uint32_t box[5];
};
static_assert(sizeof(EmuTmap) <= sizeof(CUtensorMap), "tensor map");
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0,
                                       cudaDriverEntryPointSymbolNotFound = 1 };
enum { cudaEnableDefault = 0 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

// cuTensorMapEncodeTiled, refusing what the driver refuses and the
// kernels would rely on: a base not 16-byte aligned, strides not
// multiples of 16, boxes past 256 elements a dimension, a 128-byte
// swizzle with a box row over 128 bytes, element strides other than 1.
inline CUresult emu_encode_tiled(
    CUtensorMap* map, CUtensorMapDataType dt, cuuint32_t rank, void* base,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    const cuuint32_t* estr, CUtensorMapInterleave il, CUtensorMapSwizzle sw,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill fill) {
  if (dt != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || rank < 1 || rank > 5 ||
      (uintptr_t)base % 16 || il != CU_TENSOR_MAP_INTERLEAVE_NONE ||
      fill != CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
    return CUDA_ERROR_INVALID_VALUE;
  EmuTmap t{};
  t.base = static_cast<const unsigned char*>(base);
  t.rank = rank;
  t.swizzle = sw;
  t.strides[0] = 2;
  for (unsigned i = 0; i < rank; ++i) {
    if (dims[i] < 1 || dims[i] > (1ull << 32) || box[i] < 1 ||
        box[i] > 256 || estr[i] != 1)
      return CUDA_ERROR_INVALID_VALUE;
    t.dims[i] = dims[i];
    t.box[i] = box[i];
    if (i + 1 < rank) {
      if (strides[i] % 16 || strides[i] >= (1ull << 40))
        return CUDA_ERROR_INVALID_VALUE;
      t.strides[i + 1] = strides[i];
    }
  }
  if ((box[0] * 2) % 16 ||
      (sw == CU_TENSOR_MAP_SWIZZLE_128B && box[0] * 2 > 128))
    return CUDA_ERROR_INVALID_VALUE;
  memcpy(map, &t, sizeof(t));
  return CUDA_SUCCESS;
}
inline cudaError_t cudaGetDriverEntryPointByVersion(
    const char* sym, void** fn, unsigned, unsigned long long,
    cudaDriverEntryPointQueryResult* q) {
  if (strcmp(sym, "cuTensorMapEncodeTiled") != 0) {
    *q = cudaDriverEntryPointSymbolNotFound;
    return cudaSuccess;
  }
  *fn = reinterpret_cast<void*>(&emu_encode_tiled);
  *q = cudaDriverEntryPointSuccess;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
// SMs: a persistent kernel's CTAs each walk several tiles.
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 3;
  return cudaSuccess;
}

inline EmuMbar& emu_mbar(const void* bar) {  // emu_blk->mu held
  if (!emu_in_smem(bar, 8) || (uintptr_t)bar % 8) emu_fail("mbarrier", bar);
  auto it = emu_blk->mbars.find(bar);
  if (it == emu_blk->mbars.end()) emu_fail("mbarrier not initialised", bar);
  return it->second;
}
// The phase completes once every arrival is in and every byte landed;
// deferred TMA tiles land only when `landing` (a thread waits).
inline void emu_mbar_complete(EmuMbar& m, bool landing) {
  if (m.pending != 0 || m.tx != m.deferred_bytes ||
      (!landing && !m.deferred.empty()))
    return;
  for (auto& l : m.deferred) memcpy(l.dst, l.bytes.data(), l.bytes.size());
  m.deferred.clear();
  m.deferred_bytes = m.tx = 0;
  m.phase ^= 1;
  m.pending = m.count;
}
inline void emu_mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  if (!emu_in_smem(bar, 8) || (uintptr_t)bar % 8 || count < 1)
    emu_fail("mbarrier init", bar);
  EmuMbar& m = emu_blk->mbars[bar];
  m = EmuMbar();
  m.count = m.pending = count;
}
inline void emu_mbar_arrive(uint64_t* bar, uint32_t tx) {
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  EmuMbar& m = emu_mbar(bar);
  m.tx += tx;
  if (--m.pending < 0) emu_fail("mbarrier arrival past its count", bar);
  emu_mbar_complete(m, false);
  emu_blk->cv.notify_all();
}
// Waits out the phase of parity `parity` (returns at once if the phase
// in progress has the other parity).
inline void emu_mbar_wait(uint64_t* bar, int parity) {
  std::unique_lock<std::mutex> lk(emu_blk->mu);
  EmuMbar& m = emu_mbar(bar);
  const bool ok = emu_blk->cv.wait_for(lk, std::chrono::seconds(60), [&] {
    emu_mbar_complete(m, true);
    return m.phase != (parity & 1);
  });
  if (!ok) emu_fail("mbarrier wait never completed", bar);
}
// cp.async.bulk.tensor: the box at coordinates c (innermost first), zeros
// where any coordinate is past its dimension, packed row after row and
// 128-byte swizzled (bits 4-6 of the offset XOR bits 7-9) into dst.
inline void emu_tma(void* dst, const CUtensorMap* map, const int* c,
                    int rank, uint64_t* bar) {
  EmuTmap t;
  memcpy(&t, map, sizeof(t));
  if (t.rank != rank) emu_fail("TMA rank", map);
  size_t n = 2;
  for (int i = 0; i < rank; ++i) n *= t.box[i];
  auto* d = static_cast<unsigned char*>(dst);
  const size_t align = t.swizzle == CU_TENSOR_MAP_SWIZZLE_128B ? 1024 : 128;
  if (!emu_in_smem(dst, n) || (size_t)(d - emu_smem()) % align)
    emu_fail("TMA destination", dst);
  std::vector<unsigned char> bytes(n, 0);
  for (size_t e = 0; e < n / 2; ++e) {
    size_t r = e, src = 0;
    bool inside = true;
    for (int i = 0; i < rank; ++i) {
      const long k = c[i] + (long)(r % t.box[i]);
      r /= t.box[i];
      if (k < 0 || k >= (long)t.dims[i]) inside = false;
      else src += (size_t)k * t.strides[i];
    }
    if (!inside) continue;
    size_t o = 2 * e;
    if (t.swizzle == CU_TENSOR_MAP_SWIZZLE_128B) o ^= ((o >> 7) & 7) << 4;
    memcpy(&bytes[o], t.base + src, 2);
  }
  std::lock_guard<std::mutex> lk(emu_blk->mu);
  EmuMbar& m = emu_mbar(bar);
  if (emu_copies_at_wait) {
    m.deferred.push_back({d, std::move(bytes)});
    m.deferred_bytes += n;
  } else {
    memcpy(d, bytes.data(), n);
    m.tx -= n;
    emu_mbar_complete(m, false);
  }
  emu_blk->cv.notify_all();
}

// wgmma.mma_async m64nNk16 bf16 -> f32: B through its descriptor, A
// through its own (SS) or from the warp's registers (RS: `a`, four
// packed bf16 pairs a lane in mma.sync's A fragment layout, read when the
// product runs); a descriptor's operand K-major (trans 0) or MN-major
// (trans 1), 128-byte swizzled (layout type 1, base offset 0), by the PTX
// ISA's canonical layouts; each thread computes its own accumulator
// fragment.  Run at issue, or (copies at wait) at the wgmma.wait_group
// that retires its group.
struct EmuWgmma {
  float* d;
  int n, trans_a, trans_b, scale_d;
  uint64_t da, db;
  const uint32_t* a;  // RS: this lane's A registers; SS: null
};
inline thread_local std::vector<EmuWgmma> emu_wg_open;
inline thread_local std::vector<std::vector<EmuWgmma>> emu_wg_groups;
struct EmuDesc { size_t start, lbo, sbo; };
inline EmuDesc emu_desc(uint64_t d) {
  if ((d >> 62) != 1 || ((d >> 49) & 7))
    emu_fail("wgmma descriptor: not 128-byte swizzled at base offset 0",
             nullptr);
  return {(size_t)(d & 0x3FFF) << 4, (size_t)((d >> 16) & 0x3FFF) << 4,
          (size_t)((d >> 32) & 0x3FFF) << 4};
}
inline float emu_swizzled_bf16(size_t off) {
  off ^= ((off >> 7) & 7) << 4;
  if (off % 2 || off + 2 > emu_blk->smem.size())
    emu_fail("wgmma operand", (void*)off);
  uint16_t h;
  memcpy(&h, emu_smem() + off, 2);
  return emu_bf(h);
}
// The warp's 16 x 16 A tile of an RS product from its lanes' registers:
// register r of lane l holds row l / 4 + 8 (r % 2), columns 2 (l % 4) +
// 8 (r / 2) and one more.
inline void emu_rs_tile(const uint32_t* a, float (&tile)[16][16]) {
  uint64_t* x = emu_x(emu_lane());
  for (int r = 0; r < 4; ++r) x[r] = a[r];
  emu_warp_sync();
  for (int l = 0; l < 32; ++l)
    for (int r = 0; r < 4; ++r) {
      const uint32_t w = uint32_t(emu_x(l)[r]);
      const int row = l / 4 + 8 * (r & 1), col = 2 * (l % 4) + 8 * (r >> 1);
      tile[row][col] = emu_bf(w & 0xffffu);
      tile[row][col + 1] = emu_bf(w >> 16);
    }
  emu_warp_sync();
}
inline void emu_wgmma_run(const EmuWgmma& op) {
  float rs[16][16];
  if (op.a) emu_rs_tile(op.a, rs);
  const EmuDesc a = op.a ? EmuDesc{} : emu_desc(op.da), b = emu_desc(op.db);
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
  auto kmajor = [](const EmuDesc& s, int row, int k) {
    return emu_swizzled_bf16(s.start + (row / 8) * s.sbo + (row % 8) * 128 +
                             2 * k);
  };
  auto mnmajor = [](const EmuDesc& s, int k, int col) {
    return emu_swizzled_bf16(s.start + (col / 64) * s.lbo + (k / 8) * s.sbo +
                             (k % 8) * 128 + 2 * (col % 64));
  };
  for (int i = 0; i < op.n / 2; ++i) {
    const int row = 16 * w + lane / 4 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    float acc = op.scale_d ? op.d[i] : 0.f;
    for (int k = 0; k < 16; ++k)
      acc += (op.a ? rs[row - 16 * w][k]
                   : op.trans_a ? mnmajor(a, k, row) : kmajor(a, row, k)) *
             (op.trans_b ? mnmajor(b, k, col) : kmajor(b, col, k));
    op.d[i] = acc;
  }
}
inline void emu_wgmma(float* d, int n, int trans_a, int trans_b, uint64_t da,
                      uint64_t db, int scale_d, const uint32_t* a = nullptr) {
  const EmuWgmma op{d, n, trans_a, trans_b, scale_d, da, db, a};
  if (emu_copies_at_wait) emu_wg_open.push_back(op);
  else emu_wgmma_run(op);
}
// fence, commit and wait are .sync.aligned: the warp's lanes meet there
// (a lane that releases a stage after its wait knows its warp is done).
inline void emu_wgmma_commit() {
  emu_wg_groups.push_back(emu_wg_open);
  emu_wg_open.clear();
  emu_warp_sync();
}
inline void emu_wgmma_wait(int in_flight) {
  while ((int)emu_wg_groups.size() > in_flight) {
    for (const auto& op : emu_wg_groups.front()) emu_wgmma_run(op);
    emu_wg_groups.erase(emu_wg_groups.begin());
  }
  emu_warp_sync();
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
            emu_wg_open.clear();
            emu_wg_groups.clear();
            kern(args...);
            for (const auto& g : emu_groups)
              if (!g.empty()) emu_fail("cp.async never waited for", nullptr);
            if (!emu_wg_open.empty() || !emu_wg_groups.empty())
              emu_fail("wgmma never waited for", nullptr);
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

# The asm primitives of wgmma_tma.cuh, as calls into the emulator.
WG_PRIMITIVES = """
inline uint32_t smem_addr(const void* p) {
  if (!emu_in_smem(p, 0)) emu_fail("not shared memory", p);
  return uint32_t(static_cast<const unsigned char*>(p) - emu_smem());
}
inline void mbar_init(uint64_t* bar, int count) { emu_mbar_init(bar, count); }
inline void fence_mbar_init() {}
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  emu_mbar_arrive(bar, bytes);
}
inline void mbar_arrive(uint64_t* bar) { emu_mbar_arrive(bar, 0); }
inline void mbar_wait(uint64_t* bar, int parity) { emu_mbar_wait(bar, parity); }
inline void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                        uint64_t* bar) {
  const int c[2] = {c0, c1};
  emu_tma(dst, map, c, 2, bar);
}
inline void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                        int c2, uint64_t* bar) {
  const int c[3] = {c0, c1, c2};
  emu_tma(dst, map, c, 3, bar);
}
inline void fence_proxy_async() {}
inline void named_barrier_sync(int id, int n) { emu_named_barrier(id, n); }
inline void named_barrier_arrive(int id, int n) {
  emu_named_barrier_arrive(id, n);
}
inline void wgmma_fence() { emu_warp_sync(); }
inline void wgmma_commit() { emu_wgmma_commit(); }
template <int N> inline void wgmma_wait() { emu_wgmma_wait(N); }
inline void fence_operand(float&) {}
inline float fast_exp2(float x) { return exp2f(x); }
template <int R> inline void setmaxnreg_inc() {}
template <int R> inline void setmaxnreg_dec() {}
template <int N, int TRANS_A, int TRANS_B>
inline void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int s) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  emu_wgmma(d, N, TRANS_A, TRANS_B, a, b, s);
}
template <int N>
inline void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                     int s) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  emu_wgmma(d, N, 0, 1, 0, b, s, a);
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


def build(out: Path, names) -> Path:
    """``lib<name>.so`` for each kernel source ``name`` (of
    ``flash_fwd``, ``flash_bwd``, ``paged_attention``,
    ``grouped_matmul``), built by g++ into ``out`` under the emulator,
    one g++ a source, all started together."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ with C++20 to build the emulated kernels")
    (out / "emu.h").write_text(EMU_H)
    for shim in ("cuda.h", "cuda_runtime.h", "cuda_bf16.h"):
        (out / shim).write_text('#pragma once\n#include "emu.h"\n')
    header = (CSRC / "mma_bf16.cuh").read_text()
    start = header.index("__device__ __forceinline__ uint32_t smem_u32")
    end = header.index("// Two f32 values rounded")
    (out / "mma_bf16.cuh").write_text(header[:start] + PRIMITIVES
                                      + header[end:])
    header = (CSRC / "wgmma_tma.cuh").read_text()
    start = header.index("// --- asm primitives")
    end = header.index("// --- end of asm primitives")
    (out / "wgmma_tma.cuh").write_text(header[:start] + WG_PRIMITIVES
                                       + header[end:])
    procs = []
    for name in names:
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


def run_child(script: str, args, timeout: float, copies_at_wait: bool):
    """Run ``script`` in a child Python with ``args`` under ``timeout``
    seconds (a hang guard: a kernel whose warps diverge at a barrier
    fails the test instead of hanging it); its last stdout line is
    JSON."""
    env = dict(os.environ, PYTHONPATH=str(REPO),
               EMU_COPIES_AT_WAIT=str(int(copies_at_wait)))
    run = subprocess.run(
        [sys.executable, "-c", script, *map(str, args)],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert run.returncode == 0, run.stderr[-4000:]
    import json

    return json.loads(run.stdout.strip().splitlines()[-1])


def kernel_names(lib: Path, pattern: str):
    """``(chip_smoke, names)``: the module ``chip_smoke.py`` and its
    ``_kernel_name`` of every symbol of the emulated library ``lib`` that
    matches ``pattern`` (the names its SASS check keys on)."""
    import importlib.util

    nm = shutil.which("nm")
    if nm is None:
        pytest.skip("needs nm to list the emulated library's symbols")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    symbols = subprocess.run([nm, str(lib)], capture_output=True, text=True,
                             check=True).stdout.split()
    return smoke, {smoke._kernel_name(s) for s in symbols
                   if re.search(pattern, s)}


# Runs in a child process: loads the emulated libraries through the same
# C entry points the wrappers bind, prints one JSON line of errors.
CHILD = r"""
import ctypes, json, math, sys
import torch
from horovod_tpu_torch.ops import attention as A

libdir, dtype = sys.argv[1], {"bf16": torch.bfloat16, "f32": torch.float32}[sys.argv[2]]
# "value": K1's shift by value, then K2 and K3; "device": K1 alone, its
# shift read from memory (the by-value argument a decoy).  Cases listed in
# the optional fifth argument run K1, K2 and K3 a second time, bit for
# bit against the first.
device_shift = sys.argv[4] == "device"
repeat = [tuple(c) for c in json.loads(sys.argv[5])] if len(sys.argv) > 5 else []
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
    shift_dev = None
    if device_shift:
        held = torch.tensor(shift, dtype=torch.int32)
        shift_dev = ptr(held)
        dims = dims[:7] + (1, 12345) + dims[9:]
    rc = A._bind_fwd(fwd)(*map(ptr, (q, k, v, o, lse)), *dims, None,
                          shift_dev)
    assert rc == 0, ("flash_fwd", rc)
    o_r, lse_r = A._reference_attention_lse(
        q, A.expand_kv(k, H), A.expand_kv(v, H), shift, scale)
    if device_shift:
        res[str([B, H, Hkv, S, T, D, shift])] = {
            "o": (o.float() - o_r.float()).abs().max().item(),
            "lse": (lse - lse_r).abs().max().item()}
        continue
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
    if (B, H, Hkv, S, T, D, shift) in repeat:
        again = [torch.empty_like(t) for t in (o, lse, dk, dv, dq)]
        rc = A._bind_fwd(fwd)(*map(ptr, (q, k, v, *again[:2])), *dims, None,
                              None)
        assert rc == 0, ("flash_fwd", rc)
        call(bwd, "flash_bwd_dkdv", 8, (q, k, v, do, lse_r, delta,
                                        *again[2:4]), *dims)
        call(bwd, "flash_bwd_dq", 7, (q, k, v, do, lse_r, delta, again[4]),
             *dims)
        res[str([B, H, Hkv, S, T, D, shift])]["repeat"] = all(
            torch.equal(a.view(torch.int16 if a.element_size() == 2
                               else torch.int32),
                        b.view(torch.int16 if b.element_size() == 2
                               else torch.int32))
            for a, b in zip(again, (o, lse, dk, dv, dq)))
print(json.dumps(res))
"""

# (B, H, H_kv, S, T, D, shift): tile-aligned and ragged S, GQA, both
# head dims, S != T unmasked / bottom-right causal / fully masked, a
# shifted diagonal that leaves the first rows fully masked, one query
# row, and D = 128 with GQA and a ragged S.  The last three cross more
# than one of the bf16 K1's, K2's and K3's 128-row blocks and 64-row ring
# stages both ways, with GQA (G = 2) and ragged S and T edges (the last
# K block's second warpgroup wholly past T): causal with S > T at D =
# 64, a shift of -70 with T > S and a shift of 40 at D = 128, two
# batches.
CASES = [(1, 2, 2, 64, 64, 64, 0), (1, 4, 1, 130, 130, 64, 0),
         (1, 2, 2, 17, 17, 128, None), (1, 2, 2, 100, 300, 64, -200),
         (1, 2, 2, 100, 300, 64, 200), (1, 2, 1, 150, 150, 128, 50),
         (1, 2, 2, 1, 1, 64, 0), (1, 4, 2, 77, 77, 128, 0),
         (1, 2, 1, 300, 260, 64, 0), (1, 2, 1, 200, 330, 128, -70),
         (2, 2, 1, 200, 200, 128, 40)]
# The case whose K1, K2 and K3 run twice, bit for bit.
REPEAT_CASES = [CASES[-1]]
# The f32 K1's own edges (64-row query tiles; stages of 64 keys at D =
# 64, of 32 at D = 128), each masked so that its shift also runs from
# memory: GQA G = 4 at D = 128 with S and T off the tiles and a
# bottom-right shift; a positive shift that masks the first 40 rows
# wholly, GQA G = 4 at D = 64, S and T off the tiles; a suffix (33
# queries over 161 keys, shift -128) at D = 128.
K1_F32_CASES = [(1, 4, 1, 70, 200, 128, -100), (1, 4, 1, 65, 97, 64, 40),
                (1, 4, 1, 33, 161, 128, -128)]
# The f32 K2's and K3's own edges (a CTA's 128 own rows: K2's keys,
# K3's queries; stages of 64 streamed rows at D = 64, of 32 at D = 128):
# one row with G = 2; G = 4 at D = 128, 63 queries over 161 keys
# bottom-right (two K2 blocks, the second of 33 keys; two query stages,
# the second of 31); unmasked G = 2, 161 queries over 97 keys (two K3
# blocks, a ragged key stage); two batches at D = 128 with a shift of 40
# (rows 0..39 fully masked); G = 4, S = T = 161 and a shift of 7 that
# cuts a stage; a shift of -5 at D = 128 with S and T off the stages.
K23_F32_CASES = [(1, 2, 1, 1, 1, 64, 0), (1, 4, 1, 63, 161, 128, -98),
                 (1, 4, 2, 161, 97, 64, None), (2, 2, 1, 97, 65, 128, 40),
                 (1, 4, 1, 161, 161, 64, 7), (1, 2, 1, 65, 63, 128, -5)]


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
                  ctypes.c_int, ctypes.c_int, ctypes.c_int])
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
            pps, int(qg.dtype == torch.bfloat16), Pn)
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
# blocks of the split kernel) at Dh = 96 (idle lanes) on pages of 40 rows
# (ring chunks of 64 rows that cross a page boundary); then the
# speculative verify's rows, R = G * W at G = 4: 16 (W = 4, two R blocks)
# and 20 (W = 5, three, the last one half full) with a limit on a split
# boundary.  A bf16 pool runs every R > 8 case on the rows kernel
# (one block of up to 32 rows, pages copied by TMA, columns past Dh = 96
# and rows past a page of 8 or 40 landing as zeros); the last three cases
# (`pools`: the pools that run them) are the rows kernel's alone: R = 32
# (both row tiles full) with a limit on a split boundary and a limit of
# 0, R = 20 at Dh = 128 (two boxes a row) likewise, and R = 36 (two row
# blocks, the second of 4 rows) on pages of 80 rows (two ring chunks a
# page, the second past the page's end).
PAGED_CASES = [
    dict(Hkv=2, R=4, Dh=64, ps=16, pps=2, MP=6, pages=40,
         limit=[0, 96, 32, 33, 5, 50], share=[[1, 5]]),
    dict(Hkv=2, R=1, Dh=128, ps=16, pps=3, MP=4, pages=13,
         limit=[64, 49, 0], q_bf16=True),
    dict(Hkv=2, R=8, Dh=64, ps=8, pps=2, MP=5, pages=16, limit=[40, 17, 16]),
    dict(Hkv=1, R=12, Dh=96, ps=40, pps=2, MP=3, pages=7, limit=[120, 70]),
    dict(Hkv=1, R=16, Dh=64, ps=16, pps=2, MP=4, pages=13,
         limit=[64, 30, 0]),
    dict(Hkv=2, R=20, Dh=64, ps=8, pps=2, MP=5, pages=12, limit=[40, 16]),
    dict(Hkv=1, R=32, Dh=64, ps=16, pps=2, MP=4, pages=14,
         limit=[32, 0, 61], pools=["bf16"]),
    dict(Hkv=1, R=20, Dh=128, ps=16, pps=2, MP=4, pages=13,
         limit=[64, 32, 0], q_bf16=True, pools=["bf16"]),
    dict(Hkv=1, R=36, Dh=64, ps=80, pps=1, MP=2, pages=5, limit=[150, 81],
         pools=["bf16"]),
]


# G1 and G2 through the C entry points the wrappers bind.  Mode
# "forward": G1, out = xs @ W[g]; "dx": G1 with W read transposed, dx =
# dy @ W[g]^T; "dw": G2, dW[e] = xs_e^T dy_e.  Each case: group sizes
# (empty groups, every row on one group, one row, a group of more than
# one tile, ragged T), K and N (a K not a multiple of a stage, an N past
# one tile; the last case's K and N wrap the bf16 G1's six-stage ring
# and span three of its 128-column tiles).  The outputs start as NaN, so an
# element a kernel fails to write shows.  Then, for G1's two modes, row
# invariance: case 4's rows again inside another batch (5 new rows ahead
# of group 0, group 2 emptied, so every kept row moves to another tile
# position and T changes), bit for bit.  For G2 each case also runs a
# second time, bit for bit against the first, and an empty group's dW
# must come out exactly 0.
GMM_CHILD = r"""
import ctypes, json, sys
import numpy as np
import torch
from horovod_tpu_torch.ops import grouped_matmul as GM

libdir, dtype = sys.argv[1], {"bf16": torch.bfloat16,
                              "f32": torch.float32}[sys.argv[2]]
mode = sys.argv[4] if len(sys.argv) > 4 else "forward"
lib = ctypes.CDLL(f"{libdir}/libgrouped_matmul.so")
fn, fn_dw = GM._bind(lib), GM._bind_dw(lib)
is_bf16 = int(dtype == torch.bfloat16)

def ptr(t):
    return ctypes.c_void_p(t.data_ptr())

def offsets(counts):
    return torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32)

def run(a, b, counts):
    # forward/dx: a = xs or dy, b = w (E, K, N); dw: a = xs, b = dy.
    off = offsets(counts)
    T, E = a.shape[0], len(counts)
    if mode == "dw":
        out = torch.full((E, a.shape[1], b.shape[1]), float("nan"),
                         dtype=dtype)
        rc = fn_dw(ptr(a), ptr(b), ptr(off), ptr(out), T, a.shape[1],
                   b.shape[1], E, is_bf16, None)
        ref = GM.grouped_matmul_dw_reference(a, b, off)
    else:
        tr = mode == "dx"
        out = torch.full((T, b.shape[1] if tr else b.shape[2]),
                         float("nan"), dtype=dtype)
        rc = fn(ptr(a), ptr(b), ptr(off), ptr(out), T, b.shape[1],
                b.shape[2], E, is_bf16, int(tr), None)
        ref = (GM.grouped_matmul_dx_reference if tr
               else GM.grouped_matmul_reference)(a, b, off)
    assert rc == 0, rc
    return out, ref

torch.set_num_threads(1)
res = []
for i, (counts, K, N) in enumerate(json.loads(sys.argv[3])):
    rng = np.random.RandomState(i)
    T = sum(counts)
    xs = torch.from_numpy(rng.randn(T, K).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.randn(len(counts), K, N) / np.sqrt(K))
                         .astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.randn(T, N).astype(np.float32)).to(dtype)
    a, b = {"forward": (xs, w), "dx": (dy, w), "dw": (xs, dy)}[mode]
    out, ref = run(a, b, counts)
    res.append({"err": ((out.float() - ref.float()).abs().max()
                        / ref.float().abs().max()).item()})
    if mode == "dw":
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        res[-1]["repeat"] = torch.equal(run(a, b, counts)[0].view(bits),
                                        out.view(bits))
        res[-1]["empty_zero"] = all(bool((out[e] == 0).all())
                                    for e, c in enumerate(counts) if c == 0)
    if i == 3:
        inv = (counts, a, b, out, rng)
if mode != "dw":
    counts, a, b, out, rng = inv
    starts = np.concatenate([[0], np.cumsum(counts)])
    extra = torch.from_numpy(rng.randn(5, a.shape[1]).astype(np.float32))
    a_b = torch.cat([extra.to(dtype), a[:starts[2]], a[starts[3]:]])
    out_b, _ = run(a_b, b, [counts[0] + 5, counts[1], 0, *counts[3:]])
    kept = torch.cat([out[:starts[2]], out[starts[3]:]])
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    res.append({"invariant": torch.equal(out_b[5:].view(bits),
                                         kept.view(bits))})
print(json.dumps(res))
"""

GMM_CASES = [([0, 5, 0, 12], 40, 24), ([70, 0, 0], 16, 136),
             ([0, 1], 16, 8), ([3, 9, 4, 24, 65], 32, 16),
             ([130, 0, 7, 60], 328, 264)]
# G2's own: a group longer than the bf16 kernel's six-stage ring of
# 64-row boxes (450 rows) that ends inside a box, the last group running
# past T inside its box, an empty group; every row on one group that is
# neither first nor last, between empty ones.
DW_CASES = GMM_CASES + [([0, 450, 20], 72, 136), ([0, 0, 200, 0], 136, 72)]
# The edges of G2's f32 tiles (64 K rows x 128 N columns, 16 token rows a
# stage): groups ending inside a stage (21 and 35 rows), an empty group
# and a group of one row, with K and N past a tile and off it (multiples
# of 8); T = 1 with K = N = 8; a 17-row group between empty ones.
DW_EDGE_CASES = [([21, 0, 35, 1], 72, 200), ([1], 8, 8),
                 ([0, 17, 0], 136, 40)]
