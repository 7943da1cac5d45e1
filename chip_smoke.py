#!/usr/bin/env python3
"""Drive horovod_tpu_torch's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Card: the card's name and power limit, as ``nvidia-smi`` reports them.
2. Build: every kernel under ``horovod_tpu_torch/ops/csrc/``, one
   ``nvcc`` per source, all started together, with ptxas's registers
   and spill bytes of each kernel printed.  Then the tensor-core
   check: ``cuobjdump -sass`` (from ``nvcc``'s toolkit) counts the
   ``HMMA``/``HGMMA`` instructions of every kernel function in the flash
   libraries; the bf16 K1, K2 and K3 kernels must have some.
3. Kernels against their plain PyTorch versions on the card, at the
   serving path's shapes, each maximum error printed beside its
   tolerance: flash attention forward (K1) in bf16 and f32, head_dim 64
   and 128, causal, S from 8 to 2048; paged-attention decode (K4) over
   f32, bf16 and int8 pools with an edge table (partial last page, a
   slot at table capacity, a ``limit = 0`` slot, a page shared by two
   slots, limits on a split boundary and one past it, splits wholly
   past the limit, R = 1 and 8), each case called twice and required
   to agree bit for bit; flash-attention backward (K2 dk/dv, K3 dq)
   through the autograd Function with a nonzero lse cotangent, bf16 and
   f32, head_dim 64 and 128, S 8, 100 and 2048, causal, full and shifted
   masks, MHA and GQA (G = 4), against the plain backward on the same
   forward.
   Edge shapes for K1-K3 in both dtypes: ragged S (1, 17, 63, 65,
   2047) and S = 100 against T = 300, unmasked, bottom-right causal
   (shift = S - T) and fully masked (shift = T - S); K1 also at the
   resume bucket, S = 2176 (``max_len``), B = 2.
4. Serving at full width: the d1024/L8/H16/kv4 bf16 Transformer from
   ``init_params`` seed 0, 8 slots.  First the decode tick at 8 slots
   and depth 1000 (half the slots sampling), three ways, each with its
   host wall, device busy time, idle share, kernels a tick and tok/s:
   eager and synchronous (``decode_step_paged`` and the pick called
   directly, the tick without a graph), the CUDA graph synchronous
   (``overlap=False``), and the graph with the overlapped pipeline
   (the default); the sampler's own device time.  Then the captured
   tick against the eager one: 20 ticks of a live mix from a copy of
   the same state must give equal tokens, max logits, pool bytes and
   positions, with K4 launched once a layer a replay.  Then
   ``InferenceEngine`` + ``ServingServer``: 8 concurrent ``POST
   /generate`` requests, half greedy and half sampled with fixed seeds,
   whose prompts cover the buckets 8..2048.  Every request must return
   its full token count, both kernels' launch counters must grow during
   the run, and ``decode_compilations`` must read 1 before and after.
   Then durability in bf16: the same prompts on a pool of
   ``DURABLE_PAGES`` pages, below capacity parity, so that decode growth
   suspends requests, and a decode tick raising midway through the
   burst: every request returns its full count, with at least one
   preemption and one resume, one restart, an empty journal and one
   capture; then the graph check again on the restarted engine (its pool
   reset in place).
5. Token identity: the same configuration in f32 (TF32 off for matmuls
   and cuDNN) against the per-request oracles, ``greedy_decode`` for the
   greedy requests and ``sample_decode`` at the request's seed for the
   sampled ones.  A mismatch is exempt only at or after a position where
   the oracle's top-2 margin is below ``NEAR_TIE``; every exemption is
   printed.  Then the same burst on the same engine through three
   faults, one after another (``F32_FAULTS``: a decode tick raising at
   depth 1, a fetch raising, non-finite logits): every request resumes
   and must equal the same oracles; at the end three restarts, an empty
   journal, ``healthy`` and one capture.  Printed with the card's name
   and power limit: each fault's seconds to the first clean tick after
   it, ``resume_wasted_tokens``, and each faulted burst's tok/s beside
   its clean counterpart's.  Each faulted burst is a main path of its
   own: K1 and K4 must launch during it.
6. Model gradients: a 2-layer d1024 model's f32 loss and parameter
   gradients through the kernels against the plain attention path (TF32
   off).
7. Training at full width: a size-1 NCCL process group, then 10
   data-parallel steps (``spmd.make_train_step`` +
   ``DistributedOptimizer(AdamW)``) of the d1024/L8/H16 MHA model with
   f32 master parameters and bf16 compute on one fixed batch of 8 x 2048
   tokens.  Every loss must be finite, the last below the first, and
   K1, K2 and K3 must each launch once a layer a step; step time,
   tokens/s, MFU and peak memory are printed, and one more step is
   profiled (its K3 must be the tensor-core ``flash_bwd_dq_kernel_mma``).
8. Times: each kernel at its path's shape (CUDA events around 10
   back-to-back calls, median of 20; also one call alone, which adds
   the host's launch cost; K4 and its yardstick, whose calls are
   shorter than their launching, by the profiler's device time) beside
   its bound, its achieved TFLOP/s (the bound's FLOP count over its
   time), its plain version and a PyTorch yardstick the port never
   calls, and K4's split grid; the serving run's decode tok/s, TTFT and
   per-tick time.

A ``report:`` line carries every measurement as JSON; the line before
last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
NEAR_TIE = 1e-3  # f32 top-2 logit margin under which the pick is a tie

FULL = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
            n_kv_heads=4, d_ff=4096, max_seq=2176, attention_impl="flash")
# benchmarks/transformer.py's defaults: MHA, seq 2048, batch 8 a card.
TRAIN = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
             n_kv_heads=0, d_ff=4096, max_seq=2048, attention_impl="flash")
TRAIN_BATCH, TRAIN_STEPS = 8, 10
ENGINE = dict(n_slots=8, max_len=2176, max_prefills_per_tick=2,
              page_size=16, max_queue_depth=64, default_max_new_tokens=128)
PROMPT_LENS = [5, 16, 40, 100, 300, 700, 1500, 2048]
NEW_TOKENS = [128, 64, 96, 128, 80, 112, 64, 128]
F32_NEW_TOKENS = 32
PROFILE_DEPTH = 1000  # every slot's prompt length in the profiled ticks
RESUME_S = ENGINE["max_len"]  # the prefill bucket of a resumed long prompt
# The f32 faults, one after another, each at the next visit of its site
# once the burst has emitted that many tokens in all: a decode tick
# raising at depth 1, a fetch raising, non-finite logits.
F32_FAULTS = [("decode_tick", "raise", 1), ("decode_fetch", "raise", 96),
              ("decode_tick", "nonfinite", 176)]
# The bf16 faulted burst's page pool, below capacity parity (8 x 136 =
# 1088 pages) so that decode growth runs out and preempts; it still holds
# the 8 prompts and the graph check's 20 positions beyond them.
DURABLE_PAGES = 320
# Each request's sampling, by its index: half greedy, half sampled with a
# fixed seed, every option of the sampler.
SAMPLING = [{}, dict(temperature=1.0, seed=1), {},
            dict(temperature=0.8, top_k=40, seed=2), {},
            dict(temperature=1.2, top_p=0.9, seed=3), {},
            dict(temperature=0.7, top_k=100, top_p=0.95, seed=4)]

REPORT: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warm: int = 3, batch: int = 10) -> float:
    """Median device time of one call, by CUDA events around ``batch``
    back-to-back calls (divided by ``batch``), so that the host's cost
    of launching a short kernel does not show as device time.  ``batch=1``
    times one call alone (the host's launch cost included), which is
    enough for calls that take many milliseconds."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def device_ms(fn, tag: str = "", reps: int = 20) -> float:
    """Device time of one call: ``torch.profiler``'s kernel time of
    ``reps`` calls (kernels whose name holds ``tag``), over ``reps``.
    For calls so short that back-to-back CUDA events time the host's
    launching instead."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in _device_events(prof)
                if tag in e.key)
    if total <= 0:
        raise AssertionError(f"the profiler saw no kernel matching {tag!r}")
    return total / 1e3 / reps


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"


def tflops(flops: float, ms: float) -> float:
    """Achieved rate: the bound's FLOP count over the measured time."""
    return flops / (ms * 1e-3) / 1e12


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {out}")
    REPORT["card"] = out
    return out


def build() -> None:
    from horovod_tpu_torch.ops import _cuda

    t0 = time.monotonic()
    built = _cuda.build_all()
    dt = time.monotonic() - t0
    log(f"build: {sorted(built)} in {dt:.1f} s")
    REPORT["build_s"] = dt
    # ptxas's report (-Xptxas -v): registers a thread and spill bytes of
    # each kernel, which set how many CTAs an SM holds.
    regs = {}
    for out in built.values():
        fn = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = _kernel_name(m.group(1))
                regs[fn] = {}
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and fn:
                regs[fn]["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                regs[fn]["registers"] = int(m.group(1))
    for fn, r in sorted(regs.items()):
        log(f"ptxas: {fn}: {r}")
    REPORT["ptxas"] = regs


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_kernel_mma<bf16,64>``-style name of a mangled flash
    kernel, ``paged_attend_split_kernel<int8,bf16,R4,L8>`` of a paged one
    (other names are returned as they are)."""
    paged = re.search(r"\d+(paged_attend_[a-z_]+?)(?:I(.*?)EEv|E)", mangled)
    if paged:
        kinds = {"13__nv_bfloat16": "bf16", "a": "int8", "f": "f32"}
        toks = re.findall(r"13__nv_bfloat16|S1_|Li\d+|a|f",
                          paged.group(2) or "")
        ints = iter(("R", "L"))  # query rows a CTA, lanes a position
        args = [kinds.get(t, kinds.get(toks[0])) if not t.startswith("Li")
                else next(ints) + t[2:] for t in toks]
        return paged.group(1) + (f"<{','.join(args)}>" if args else "")
    name = re.search(r"\d+(flash_[a-z_]+?)I", mangled)
    dim = re.search(r"Li(\d+)E", mangled)
    if not (name and dim):
        return mangled
    dtype = "bf16" if "bfloat16" in mangled else "f32"
    return f"{name.group(1)}<{dtype},{dim.group(1)}>"


def sass_check() -> dict:
    """Tensor-core instructions (``HMMA``, ``HGMMA``) in each kernel
    function of the flash libraries, by ``cuobjdump -sass`` from the
    toolkit of the ``nvcc`` that built them.  Fails unless both bf16
    instantiations (D = 64, 128) of K1, K2 and K3 have some."""
    from horovod_tpu_torch.ops import _cuda

    tool = Path(_cuda._nvcc()).resolve().parent / "cuobjdump"
    counts = {}
    for lib in ("flash_fwd", "flash_bwd"):
        sass = subprocess.run(
            [str(tool), "-sass", str(_cuda.BUILD_DIR / f"lib{lib}.so")],
            capture_output=True, text=True, timeout=300, check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = _kernel_name(m.group(1))
                counts[fn] = 0
            elif fn is not None and re.search(r"\bHG?MMA\b", line):
                counts[fn] += 1
    for fn, n in sorted(counts.items()):
        log(f"sass: {fn}: {n} HMMA/HGMMA")
    for tag in ("flash_fwd_kernel_mma", "flash_bwd_dkdv_kernel_mma",
                "flash_bwd_dq_kernel_mma"):
        got = [n for fn, n in counts.items() if fn.startswith(tag + "<")]
        if len(got) != 2 or not all(got):
            raise AssertionError(f"{tag}: expected tensor-core instructions "
                                 f"in both instantiations, got {got}")
    return counts


# --- phase 3: kernels against their plain versions ---------------------------


def _k1_inputs(B, H, Hkv, S, D, dtype, seed, T=None):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    T = S if T is None else T
    return r(B, H, S, D), r(B, Hkv, T, D), r(B, Hkv, T, D)


def _shift(mask: str, S: int, T: int):
    """The mask names of the checks as the kernels' shift: position (row,
    col) attends iff col + shift <= row; None is unmasked."""
    return {"causal": 0, "full": None, "shift": S // 3,
            "bottom_right": S - T, "none_visible": T - S}[mask]


# Edge shapes of K1-K3: ragged S, and S != T under each mask kind.
EDGE_S = (1, 17, 63, 65, 2047)
EDGE_T = (100, 300)  # (S, T)
EDGE_T_MASKS = ("full", "bottom_right", "none_visible")


def check_flash() -> dict:
    from horovod_tpu_torch.ops import attention as A

    worst = {}
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    dts = (torch.bfloat16, torch.float32)
    cases = [(dt, D, S, S, "causal") for dt in dts
             for D in (64, 128) for S in (8, 100, 2048)]
    cases += [(dt, 64, 256, 256, "full") for dt in dts]
    cases += [(dt, 64, S, S, "causal") for dt in dts for S in EDGE_S]
    cases += [(dt, D, *EDGE_T, m) for dt in dts for D in (64, 128)
              for m in EDGE_T_MASKS]
    # The resume bucket: a resumed 2048-token prompt plus its emitted
    # tokens prefills at max_len, 2176, which warmup never reaches.
    cases += [(dt, 64, RESUME_S, RESUME_S, "causal") for dt in dts]
    for i, (dt, D, S, T, mask) in enumerate(cases):
        B, H, Hkv = 2, 16, 4
        shift = _shift(mask, S, T)
        q, k, v = _k1_inputs(B, H, Hkv, S, D, dt, seed=i, T=T)
        if shift is None:
            o, lse = A.flash_attention_with_lse(q, k, v, False)
        else:
            o, lse = A.flash_attention_shifted(q, k, v, shift)
        o_r, l_r = A._reference_attention_lse(
            q, A.expand_kv(k, H), A.expand_kv(v, H), shift,
            1.0 / math.sqrt(D))
        torch.cuda.synchronize()
        err = max((o.float() - o_r.float()).abs().max().item(),
                  (lse - l_r).abs().max().item())
        name = f"K1 {str(dt)[6:]} D={D} S={S} T={T} {mask}"
        log(f"{name}: max_abs_err={err:.3e} tol={tol[dt]:.0e}")
        if not err <= tol[dt]:
            raise AssertionError(f"{name} disagrees with its plain version")
        if dt == torch.bfloat16 and D == 64 and S == T == 2048:
            worst["serving"] = err
        worst[name] = err
    return worst


def _rel_err(got, want) -> float:
    """Max abs error over max(1, max |want|)."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1.0)).item()


def check_flash_bwd() -> dict:
    """K2 and K3 through the autograd Function against the plain backward
    on the same forward results.  Tolerance, relative to the largest
    gradient (floored at 1): f32 1e-4 (summation order); bf16 2e-2 (p,
    ds and the outputs round to bf16, whose step is 2^-8 of a value; the
    kernel and the plain version sum in other orders, so a few entries
    round one step apart).  The shifted mask (shift = S // 3) leaves the
    first rows fully masked (lse = NEG_INF)."""
    from horovod_tpu_torch.ops import attention as A

    bf16, f32 = torch.bfloat16, torch.float32
    tol = {f32: 1e-4, bf16: 2e-2}
    masks = ("causal", "full", "shift")
    cases = [(dt, D, S, S, m, G) for dt in (bf16, f32) for D in (64, 128)
             for S in (8, 100) for m in masks for G in (1, 4)]
    cases += [(dt, D, 2048, 2048, m, 4) for dt in (bf16, f32)
              for D in (64, 128) for m in masks]
    # The training run's attention (MHA), at B = 2: its errors go in the
    # kernels line.
    cases.append((bf16, 64, 2048, 2048, "causal", 1))
    cases += [(dt, 64, S, S, "causal", G) for dt in (bf16, f32)
              for S in EDGE_S for G in (1, 4)]
    cases += [(dt, D, *EDGE_T, m, 4) for dt in (bf16, f32) for D in (64, 128)
              for m in EDGE_T_MASKS]
    worst, failed = {}, []
    for i, (dt, D, S, T, mask, G) in enumerate(cases):
        B, H = 2, 16
        shift = _shift(mask, S, T)
        q, k, v = _k1_inputs(B, H, H // G, S, D, dt, seed=200 + i, T=T)
        g = torch.Generator(device="cuda").manual_seed(400 + i)
        do = torch.randn((B, H, S, D), generator=g, device="cuda").to(dt)
        dlse = torch.randn((B, H, S), generator=g, device="cuda")
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        scale = 1.0 / math.sqrt(D)
        o, lse = A._FlashAttention.apply(q, k, v, shift, scale)
        dq, dk, dv = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
        delta = (do.float() * o.float()).sum(-1) - dlse
        rq, rk, rv = A._flash_bwd_reference(
            q.detach(), k.detach(), v.detach(), do, lse.detach(), delta,
            shift, scale)
        torch.cuda.synchronize()
        err = max(_rel_err(a, b) for a, b in ((dq, rq), (dk, rk), (dv, rv)))
        name = f"K2/K3 {str(dt)[6:]} D={D} S={S} T={T} {mask} G={G}"
        log(f"{name}: rel_err={err:.3e} tol={tol[dt]:.0e}")
        if not err <= tol[dt]:
            failed.append(name)
        worst[name] = err
        if S == T == 2048 and G == 1:
            worst["training"] = {
                "dkdv": max((dk.float() - rk.float()).abs().max().item(),
                            (dv.float() - rv.float()).abs().max().item()),
                "dq": (dq.float() - rq.float()).abs().max().item()}
        del q, k, v, o, lse, do, dq, dk, dv, rq, rk, rv
    if failed:
        raise AssertionError(f"K2/K3 disagree with the plain backward: "
                             f"{failed}")
    return worst


# Slot limits of the K4 checks at the serving shape (8 slots, 136 pages
# of 16, split_grid: 9 pages = 144 positions a split): a slot at table
# capacity, a partial last page, limit 0, two slots sharing pages.
K4_LIMITS = [16 * 136, 5, 0, 16 + 3, 1000, 1, 2048, 777]
# Split edges: on a split boundary (144, 288) and one position past it,
# one short of it, and slots whose later splits are all past the limit.
K4_SPLIT_LIMITS = [144, 145, 0, 288, 289, 143, 16 * 136, 17]


def _k4_case(kind, compute, Dh=64, S=8, Hkv=4, R=4, ps=16, MP=136,
             P=1089, seed=0, lim=K4_LIMITS):
    from horovod_tpu_torch.models import transformer as T

    g = torch.Generator(device="cuda").manual_seed(seed)
    qg = torch.randn((S, Hkv, R, Dh), generator=g, device="cuda")
    kf = torch.randn((P, Hkv, ps, Dh), generator=g, device="cuda")
    vf = torch.randn((P, Hkv, ps, Dh), generator=g, device="cuda")
    table = torch.randint(1, P, (S, MP), generator=g, device="cuda",
                          dtype=torch.int32)
    table[1] = table[0]                       # a page shared by two slots
    limit = torch.tensor(lim[:S], dtype=torch.int32, device="cuda")
    if kind == "int8":
        kq, ks = T.kv_quantize(kf)
        vq, vs = T.kv_quantize(vf)
        args = (qg.to(compute), kq, vq, ks, vs)
    else:
        args = (qg.to(kind), kf.to(kind), vf.to(kind), None, None)
    return args, table, limit


def check_paged() -> dict:
    """K4 against its plain version; every case is called twice and the
    two results must be equal bit for bit (no atomics, partials combined
    in split order)."""
    from horovod_tpu_torch.ops import paged_attention as PA

    worst = {}
    f32, bf16 = torch.float32, torch.bfloat16
    # (pool, compute dtype, Dh, R, limits, tolerance)
    cases = [(f32, f32, 64, 4, K4_LIMITS, 1e-4),
             (bf16, bf16, 64, 4, K4_LIMITS, 2e-2),
             ("int8", bf16, 64, 4, K4_LIMITS, 2e-2),
             ("int8", f32, 64, 4, K4_LIMITS, 1e-4),
             (bf16, bf16, 128, 4, K4_LIMITS, 2e-2),
             (f32, f32, 64, 4, K4_SPLIT_LIMITS, 1e-4),
             (bf16, bf16, 64, 4, K4_SPLIT_LIMITS, 2e-2),
             ("int8", bf16, 128, 4, K4_SPLIT_LIMITS, 2e-2),
             (bf16, bf16, 64, 1, K4_SPLIT_LIMITS, 2e-2),
             (bf16, bf16, 64, 8, K4_LIMITS, 2e-2),
             (f32, f32, 128, 8, K4_SPLIT_LIMITS, 1e-4)]
    for i, (kind, compute, Dh, R, lim, tol) in enumerate(cases):
        args, table, limit = _k4_case(kind, compute, Dh=Dh, R=R, seed=i,
                                      lim=lim)
        o, lse = PA.paged_attend(*args, table, limit, compute_dtype=compute)
        o2, lse2 = PA.paged_attend(*args, table, limit,
                                   compute_dtype=compute)
        o_r, l_r = PA.paged_attend_reference(*args, table, limit,
                                             compute_dtype=compute)
        torch.cuda.synchronize()
        live = limit > 0
        err = max((o - o_r).abs().max().item(),
                  (lse[live] - l_r[live]).abs().max().item())
        edges = "split edges" if lim is K4_SPLIT_LIMITS else "edge table"
        name = f"K4 pool={str(kind).replace('torch.', '')} " \
               f"compute={str(compute)[6:]} Dh={Dh} R={R} {edges}"
        log(f"{name}: max_abs_err={err:.3e} tol={tol:.0e}")
        if not err <= tol:
            raise AssertionError(f"{name} disagrees with its plain version")
        if o[~live].abs().max().item() != 0 or \
                not (lse[~live] <= PA.NEG_INF / 2).all():
            raise AssertionError(f"{name}: a limit=0 slot is not (0, NEG_INF)")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{name}: two calls differ")
        if kind == bf16 and Dh == 64 and R == 4 and lim is K4_LIMITS:
            worst["serving"] = err
        worst[name] = err
    return worst


# --- phases 4 and 5: serving --------------------------------------------------


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, FULL["vocab_size"], n).tolist()
            for n in PROMPT_LENS]


def _post(url, payload, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _device_events(prof):
    """The profile's kernels and copies on the card.  Left out, because
    they repeat a kernel's time: CPU-side events (an operation that
    launches a kernel itself, such as an autograd Function's ctypes
    launch, carries that kernel's time as its own) and annotated ranges
    on the device timeline (the optimizer's step)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]


def _grant_ahead(engine, n: int) -> None:
    """Pages for every active slot's next ``n`` positions, and the tick's
    table, tokens, mask and sampling columns refreshed from the host:
    the state a tick run outside the engine (the eager twin) needs."""
    from horovod_tpu_torch.serving import NULL_PAGE

    ps = engine.slots.page_size
    for s in range(engine.engine_cfg.n_slots):
        if engine._states[s] is None:
            continue
        p0 = int(engine._page_pos[s])
        for idx in range(p0 // ps, (p0 + n) // ps + 1):
            if engine.slots.table[s, idx] == NULL_PAGE:
                engine.slots.grant(s, idx)
    tick = engine._tick
    tick.table.copy_(torch.from_numpy(engine.slots.table))
    tick.tokens.copy_(torch.from_numpy(engine._host_tokens()))
    tick.active.copy_(torch.from_numpy(engine.slots.active_mask()))
    engine._samp.device()


def _fill_slots(engine, depth: int, new_tokens: int, seed: int):
    """Every slot busy at ``depth``, half of them sampling; the pipeline
    running (two ticks past the last admission)."""
    rng = np.random.default_rng(seed)
    futs = [engine.submit(rng.integers(0, FULL["vocab_size"], depth).tolist(),
                          max_new_tokens=new_tokens, **SAMPLING[i % 8])
            for i in range(ENGINE["n_slots"])]
    while engine.scheduler.depth or engine._taken:
        engine.step()
    for _ in range(2):
        engine.step()
    return futs


def profile_decode(engine, mode: str, sampler_ms: float,
                   n_ticks: int = 8) -> dict:
    """Where a steady decode tick's time goes, 8 slots at depth
    ``PROFILE_DEPTH`` (half sampling), in one of three modes:
    ``eager_sync`` — ``decode_step_paged`` and the pick called directly
    (``DecodeTick.body`` on a twin of the engine's state) and fetched
    at once, the tick without a graph; ``graph_sync`` —
    ``engine.step()`` of an ``overlap=False`` engine, one replay and one
    fetch a tick;
    ``graph_overlap`` — ``engine.step()`` of the default engine.
    ``n_ticks`` ticks timed by the host clock, then ``n_ticks`` more
    under ``torch.profiler`` for device time by kernel (the profiler's
    host cost stays out of the wall time).  ``sampler_ms``: the pick's
    device time (:func:`sampler_device_ms`; the same kernels run in every
    mode, and inside a graph the profiler cannot tell them apart)."""
    from horovod_tpu_torch.serving.graph import download
    from torch.profiler import ProfilerActivity, profile

    futs = _fill_slots(engine, PROFILE_DEPTH, 3 * n_ticks + 8, seed=2)
    if mode == "eager_sync":
        _grant_ahead(engine, 2 * n_ticks + 2)
        twin = engine._tick.twin()

        def tick():
            download(*twin.body()).wait()
    else:
        tick = engine.step
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n_ticks):
        tick()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / n_ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            tick()
        torch.cuda.synchronize()
    if mode == "eager_sync":
        del twin
    while not all(f.done() for f in futs):
        engine.step()
    kernels, launches = {}, 0
    for e in _device_events(prof):
        kernels[e.key] = e.self_device_time_total / 1e3 / n_ticks  # ms a tick
        launches += e.count
    busy = sum(kernels.values())
    if busy <= 0:
        raise AssertionError(f"{mode}: the profiler recorded no device time")
    # K4 is two kernels a call: split and combine.
    k4 = sum(t for k, t in kernels.items() if "paged_attend_" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out = {"mode": mode, "ticks": n_ticks, "tick_wall_ms": wall_ms,
           "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
           "paged_attend_ms": k4, "paged_attend_share_of_busy": k4 / busy,
           "kernels_launched_per_tick": launches / n_ticks,
           "sampler_ms": sampler_ms,
           "sampler_share_of_busy": sampler_ms / busy,
           "tok_per_s": ENGINE["n_slots"] / wall_ms * 1e3,
           "top_kernels_ms": {k[:70]: t for k, t in top}}
    log(f"decode tick {mode} (8 slots at depth {PROFILE_DEPTH}): wall "
        f"{wall_ms:.3f} ms, device busy {busy:.3f} ms (idle share "
        f"{out['idle_share']:.3f}), paged_attend {k4:.3f} ms, "
        f"{out['kernels_launched_per_tick']:.0f} kernels per tick, "
        f"sampler {sampler_ms:.3f} ms ({sampler_ms / busy:.1%} of busy), "
        f"{out['tok_per_s']:.1f} tok/s")
    return out


def sampler_device_ms() -> dict:
    """Device time of the tick's sampled pick alone, at the tick's shape
    (8 slots x 32000 f32 logits, half sampling), by the profiler."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving.sampling import SlotSampling

    samp = SlotSampling(ENGINE["n_slots"], "cuda")
    for i, kw in enumerate(SAMPLING):
        if kw:
            samp.set(i, temperature=kw["temperature"],
                     top_k=kw.get("top_k", 0), top_p=kw.get("top_p", 0.0),
                     seed=kw["seed"])
    cols = samp.device()
    g = torch.Generator(device="cuda").manual_seed(9)
    logits = torch.randn((ENGINE["n_slots"], FULL["vocab_size"]),
                         generator=g, device="cuda") * 3
    pos = torch.full((ENGINE["n_slots"],), PROFILE_DEPTH + 1,
                     dtype=torch.int64, device="cuda")
    ms = device_ms(lambda: T.sample_token_rows(logits, *cols, pos,
                                               torch.zeros_like(pos)))
    log(f"sampler (8 x {FULL['vocab_size']} f32): {ms:.4f} ms device time")
    return {"sampler_ms": ms}


def graph_vs_eager(engine, n_ticks: int = 20) -> dict:
    """The captured tick against the eager one, bit for bit: every slot
    busy (half sampling, unequal depths), ``n_ticks`` replays against
    ``n_ticks`` eager runs of ``DecodeTick.body`` on a copy of the same
    state, one slot leaving halfway.  Tokens, max logits, pool bytes and
    positions must be equal; K4 must launch once a layer a replay.
    Leaves the engine's host mirror behind its pool: terminates it."""
    from horovod_tpu_torch.ops import paged_attention as PA

    rng = np.random.default_rng(4)
    for i in range(ENGINE["n_slots"]):
        engine.submit(rng.integers(0, FULL["vocab_size"],
                                   PROMPT_LENS[i]).tolist(),
                      max_new_tokens=64, **SAMPLING[i])
    while engine.scheduler.depth or engine._taken:
        engine.step()
    _grant_ahead(engine, n_ticks)
    tick = engine._tick
    twin = tick.twin()
    k4, replays = PA.paged_attend_launches, tick.replays
    graphed = []
    for i in range(n_ticks):
        if i == n_ticks // 2:
            tick.active[3] = False
        nxt, mx = tick.run()
        graphed.append((nxt.clone(), mx.clone()))
    k4_per_replay = (PA.paged_attend_launches - k4) / (tick.replays - replays)
    for i in range(n_ticks):
        if i == n_ticks // 2:
            twin.active[3] = False
        nxt, mx = twin.body()
        if not (torch.equal(nxt, graphed[i][0])
                and torch.equal(mx, graphed[i][1])):
            raise AssertionError(f"graph tick {i} differs from the eager "
                                 "tick")
    differ = [k for k, t in tick.pool.items()
              if not torch.equal(t, twin.pool[k])]
    if differ:
        raise AssertionError(f"graph and eager pools differ: {differ}")
    if k4_per_replay != FULL["n_layers"]:
        raise AssertionError(f"K4 launched {k4_per_replay} times a replay")
    engine.terminate("graph check done")
    log(f"graph vs eager: {n_ticks} ticks bit-identical (tokens, max "
        f"logits, pool, pos), K4 {k4_per_replay:.0f} launches a replay")
    return {"ticks": n_ticks, "bit_identical": True,
            "k4_launches_per_replay": k4_per_replay}


def serve_full_width() -> dict:
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                           ServingServer)

    cfg = T.TransformerConfig(**FULL, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0)
    n_params = sum(t.numel() for t in [params["embed"], params["head"],
                                        params["ln_f"],
                                        *params["layers"].values()])
    # The synchronous engine: the eager and graph-synchronous decode
    # profiles, then the graph-against-eager check (which ends it).
    sampler = sampler_device_ms()
    sync = InferenceEngine(params, cfg, EngineConfig(**ENGINE, overlap=False))
    sync.warmup((8,))
    modes = [profile_decode(sync, "eager_sync", sampler["sampler_ms"]),
             profile_decode(sync, "graph_sync", sampler["sampler_ms"])]
    check = graph_vs_eager(sync)
    del sync
    engine = InferenceEngine(params, cfg, EngineConfig(**ENGINE))
    engine.warmup((8,))
    captures0 = engine.stats()["decode_compilations"]
    modes.append(profile_decode(engine, "graph_overlap",
                                sampler["sampler_ms"]))
    sampler["share_of_tick_busy"] = modes[-1]["sampler_share_of_busy"]
    ticks0 = engine.metrics.decode_ticks.value
    sums0 = {k: getattr(engine.metrics, k).snapshot()["sum"]
             for k in ("tick_dispatch", "tick_device_wait", "tick_host")}
    srv = ServingServer(engine, port=0, request_timeout=600).start()
    url = "http://%s:%d/generate" % srv.address
    prompts = _prompts()
    results = [None] * len(prompts)
    # The main path's run: the launch counters read 0 here and are read
    # again when the last request has returned.
    A.flash_fwd_launches = 0
    PA.paged_attend_launches = 0
    t0 = time.monotonic()

    def client(i):
        results[i] = _post(url, {"tokens": prompts[i],
                                 "max_new_tokens": NEW_TOKENS[i],
                                 **SAMPLING[i]})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.monotonic() - t0
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches}
    stats = engine.stats()
    srv.stop()
    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            raise AssertionError(f"request {i} failed: {res}")
        body = res[1]
        if len(body["tokens"]) != NEW_TOKENS[i] or \
                body["finish_reason"] != "length":
            raise AssertionError(f"request {i} returned "
                                 f"{len(body['tokens'])} tokens "
                                 f"({body['finish_reason']})")
    if not (launches["flash_fwd"] > 0 and launches["paged_attend"] > 0):
        raise AssertionError(f"the serving run missed a kernel: {launches}")
    captures = (captures0, stats["decode_compilations"])
    if captures != (1, 1):
        raise AssertionError(f"decode_compilations before/after the burst: "
                             f"{captures}, expected 1 and 1")
    ticks = stats["decode_ticks"] - ticks0
    tick_s = sum(stats[f"{k}_seconds"]["sum"] - sums0[k] for k in sums0)
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    total = sum(NEW_TOKENS)
    out = {
        "params": n_params, "requests": len(prompts),
        "prompt_lens": PROMPT_LENS, "new_tokens": NEW_TOKENS,
        "sampling": SAMPLING,
        "wall_s": wall, "tokens": total, "tok_per_s": total / wall,
        "decode_ticks": ticks, "tick_ms_mean": tick_s / ticks * 1e3,
        "ttft_ms_p50": statistics.median(ttft), "ttft_ms_max": ttft[-1],
        "launches": launches,
        "decode_compilations_before_after": list(captures),
        "host_syncs_per_tick": stats["host_syncs_per_tick"],
        "kv_pages_high_water": stats["kv_pages_high_water"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "decode_modes": modes, "sampler": sampler,
        "graph_vs_eager": check,
    }
    log(f"serving bf16: {len(prompts)} requests (half sampled), {total} "
        f"tokens in {wall:.3f} s = {out['tok_per_s']:.1f} tok/s; {ticks} "
        f"decode ticks at {out['tick_ms_mean']:.3f} ms; TTFT p50 "
        f"{out['ttft_ms_p50']:.1f} ms max {out['ttft_ms_max']:.1f} ms; "
        f"launches {launches}; decode_compilations before/after "
        f"{captures}; sampler {sampler['share_of_tick_busy']:.1%} of the "
        "graph tick's device busy")
    del engine
    torch.cuda.empty_cache()
    out["durability"] = durability_bf16(params, cfg)
    del params
    torch.cuda.empty_cache()
    return out


def durability_bf16(params, cfg) -> dict:
    """The serving phase's configuration and prompts on a pool of
    ``DURABLE_PAGES`` pages, below capacity parity, so that decode growth
    runs out of pages and suspends requests, and one decode tick raising
    midway through the burst.  Every request must return its full token
    count, with at least one preemption and one resume, one capture
    throughout; then the graph check again on the restarted engine (its
    pool and inputs reset in place): 20 replays bit-identical to the
    eager tick, K4 once a layer a replay."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import (EngineConfig, FaultInjector,
                                           InferenceEngine)

    inj = FaultInjector()
    engine = InferenceEngine(params, cfg, EngineConfig(
        **ENGINE, n_pages=DURABLE_PAGES, faults=inj))
    engine.warmup((8,))
    prompts = _prompts()
    # The durability phase's main path: the launch counters read 0 here
    # and are read again after its last request.
    A.flash_fwd_launches = 0
    PA.paged_attend_launches = 0
    futs = [engine.submit(p, max_new_tokens=n, **SAMPLING[i])
            for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS))]
    faults = [("decode_tick", "raise", sum(NEW_TOKENS) // 2)]
    run = _burst_with_faults(engine, inj, futs, faults)
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches}
    for i, f in enumerate(futs):
        got = f.result(timeout=0)
        if len(got) != NEW_TOKENS[i] or f.finish_reason != "length":
            raise AssertionError(f"bf16 faulted request {i} returned "
                                 f"{len(got)} tokens ({f.finish_reason})")
    st = _durability_checks("bf16 faulted", engine, launches, 1)
    if st["preemptions"] < 1 or st["requests_resumed"] < 1:
        raise AssertionError(
            f"bf16 faulted burst: preemptions {st['preemptions']}, "
            f"requests_resumed {st['requests_resumed']}, expected >= 1 each")
    out = {"n_pages": DURABLE_PAGES, "faults": faults, "fired": inj.fired,
           "recovery_s": run["recovery_s"],
           "preemptions": st["preemptions"],
           "requests_resumed": st["requests_resumed"],
           "resume_wasted_tokens": st["resume_wasted_tokens"],
           "kv_pages_high_water": st["kv_pages_high_water"],
           "launches": launches,
           "faulted_tok_per_s": sum(NEW_TOKENS) / run["wall_s"]}
    log(f"durability bf16 ({DURABLE_PAGES} pages): fault fired "
        f"{inj.fired}; {st['preemptions']} preemptions, "
        f"{st['requests_resumed']} resumes, every request its full count; "
        f"restarts 1, journal_inflight 0, healthy, decode_compilations 1; "
        f"launches {launches}")
    out["graph_vs_eager"] = graph_vs_eager(engine)  # ends the engine
    if engine.stats()["decode_compilations"] != 1:
        raise AssertionError("the restarted engine recaptured its tick")
    del engine
    torch.cuda.empty_cache()
    return out


def _f32_oracles(params, cfg, prompts) -> list:
    """Each request's oracle tokens and top-2 margins: ``greedy_decode``
    for greedy requests, ``sample_decode`` at the request's seed for
    sampled ones."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving import seed_key

    refs = []
    for i, p in enumerate(prompts):
        kw = dict(SAMPLING[i])
        prompt = torch.tensor([p], device="cuda")
        if kw:
            ref, gap = T.sample_decode(params, prompt, F32_NEW_TOKENS, cfg,
                                       rng=seed_key(kw.pop("seed")),
                                       margins=True, **kw)
        else:
            ref, gap = T.greedy_decode(params, prompt, F32_NEW_TOKENS, cfg,
                                       margins=True)
        refs.append((ref[0].tolist(), gap[0].tolist()))
    return refs


def _check_f32(label: str, prompts, futs, refs) -> list:
    """Every future's tokens against its oracle.  A mismatch is exempt
    only at or after a pick whose oracle top-2 gap is below
    ``NEAR_TIE``; returns the exemptions."""
    exempt = []
    for i, (p, f, (ref, gap)) in enumerate(zip(prompts, futs, refs)):
        got = f.result(timeout=0)
        if got == ref:
            continue
        first = next((j for j in range(len(ref))
                      if j >= len(got) or got[j] != ref[j]), len(ref))
        ties = [j for j in range(min(first + 1, len(ref)))
                if gap[j] < NEAR_TIE]
        if len(got) != len(ref) or not ties:
            raise AssertionError(
                f"{label} request {i} (prompt {len(p)}, "
                f"{SAMPLING[i] or 'greedy'}, {len(got)} tokens) diverges "
                f"from the oracle at token {first}")
        exempt.append({"request": i, "prompt_len": len(p),
                       "sampled": bool(SAMPLING[i]),
                       "first_mismatch": first, "tie_at": ties[0],
                       "margin": gap[ties[0]]})
        log(f"exemption: {label} request {i} diverges at token {first} "
            f"after a near-tie at token {ties[0]} (margin "
            f"{gap[ties[0]]:.3e} < {NEAR_TIE})")
    return exempt


def _burst_with_faults(engine, inj, futs, faults) -> dict:
    """Step ``engine`` until every future resolves, injecting each
    ``(site, kind, at)`` of ``faults`` at the next visit of its site once
    the burst has emitted ``at`` tokens in all.  Each fault must restart
    the engine; its recovery time runs from the step it is armed before
    to the end of the first clean tick after the restart (the engine
    back to ``healthy``), synchronized."""
    from horovod_tpu_torch.serving import FaultSpec

    def emitted():
        return sum(len(f.tokens_so_far()) for f in futs)

    def step():
        if engine.terminal or all(f.done() for f in futs):
            raise AssertionError(f"the faulted burst ended early: "
                                 f"{engine.stats()['error']}")
        engine.step()

    recoveries = []
    t0 = time.monotonic()
    for site, kind, at in faults:
        while emitted() < at:
            step()
        restarts = engine.metrics.engine_restarts.value
        inj.add(FaultSpec(site=site, kind=kind, skip=inj.visits(site)))
        t_fault = time.monotonic()
        while engine.metrics.engine_restarts.value == restarts:
            step()
        while engine.health != "healthy":
            if engine.terminal:
                raise AssertionError("the engine went terminal")
            engine.step()
        torch.cuda.synchronize()
        recoveries.append(time.monotonic() - t_fault)
    while not all(f.done() for f in futs):
        engine.step()
    torch.cuda.synchronize()
    return {"wall_s": time.monotonic() - t0, "recovery_s": recoveries}


def _durability_checks(label: str, engine, launches: dict, restarts: int):
    """What every faulted burst must leave: the expected restarts, an
    empty journal, a healthy engine, one capture, and both kernels of
    the path launched during the burst."""
    st = engine.stats()
    got = (st["engine_restarts"], st["journal_inflight"], st["state"],
           st["decode_compilations"])
    if got != (restarts, 0, "healthy", 1):
        raise AssertionError(
            f"{label}: (engine_restarts, journal_inflight, state, "
            f"decode_compilations) = {got}, expected "
            f"({restarts}, 0, 'healthy', 1)")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"{label}: the faulted burst missed a kernel: "
                             f"{launches}")
    return st


def token_identity() -> dict:
    """f32 engine tokens of a half-sampled burst against the per-request
    oracles: ``greedy_decode`` for greedy requests, ``sample_decode`` at
    the request's seed for sampled ones.  A mismatch is exempt only at
    or after a pick whose oracle top-2 gap is below ``NEAR_TIE``.  Then
    the same burst on the same engine through the three ``F32_FAULTS``:
    every request resumes, and its tokens must equal the same oracle."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import (EngineConfig, FaultInjector,
                                           InferenceEngine)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = T.TransformerConfig(**FULL, dtype=torch.float32)
    params = T.init_params(cfg, seed=0)
    inj = FaultInjector()  # no fault until the faulted burst adds them
    engine = InferenceEngine(params, cfg, EngineConfig(**ENGINE, faults=inj))
    engine.warmup((8,))
    prompts = _prompts(seed=1)
    t0 = time.monotonic()
    futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS, **SAMPLING[i])
            for i, p in enumerate(prompts)]
    while not all(f.done() for f in futs):
        engine.step()
    torch.cuda.synchronize()
    clean_s = time.monotonic() - t0
    refs = _f32_oracles(params, cfg, prompts)
    exempt = _check_f32("f32", prompts, futs, refs)
    captures = engine.stats()["decode_compilations"]
    if captures != 1:
        raise AssertionError(f"f32 engine captured {captures} ticks")
    log(f"token identity f32: {len(prompts)} requests (half sampled) x "
        f"{F32_NEW_TOKENS} tokens, {len(exempt)} near-tie exemptions "
        "(TF32 off)")
    # The faulted burst: the durability phase's main path, its launch
    # counters read 0 here and are read again after its last request.
    A.flash_fwd_launches = 0
    PA.paged_attend_launches = 0
    futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS, **SAMPLING[i])
            for i, p in enumerate(prompts)]
    run = _burst_with_faults(engine, inj, futs, F32_FAULTS)
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches}
    fault_exempt = _check_f32("f32 faulted", prompts, futs, refs)
    st = _durability_checks("f32 faulted", engine, launches,
                            len(F32_FAULTS))
    tokens = len(prompts) * F32_NEW_TOKENS
    faulted = {"faults": F32_FAULTS, "exemptions": fault_exempt,
               "fired": inj.fired, "recovery_s": run["recovery_s"],
               "engine_restarts": st["engine_restarts"],
               "requests_resumed": st["requests_resumed"],
               "resume_wasted_tokens": st["resume_wasted_tokens"],
               "launches": launches,
               "clean_tok_per_s": tokens / clean_s,
               "faulted_tok_per_s": tokens / run["wall_s"]}
    log(f"durability f32: faults {[f[:2] for f in F32_FAULTS]} fired "
        f"{inj.fired}; {st['requests_resumed']} resumes, "
        f"{len(fault_exempt)} near-tie exemptions; restarts "
        f"{st['engine_restarts']}, journal_inflight 0, healthy, "
        f"decode_compilations 1; launches {launches}")
    del engine, params
    torch.cuda.empty_cache()
    return {"requests": len(prompts), "exemptions": exempt,
            "durability": faulted}


# --- phases 6 and 7: training --------------------------------------------------


def model_grads_f32() -> dict:
    """f32 loss and every parameter gradient of a 2-layer model, attention
    by K1-K3 against the plain softmax attention, TF32 off.  Tolerance:
    1e-4 of each parameter's largest gradient (f32 summation order)."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.optim import named_parameters

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = dict(FULL, n_layers=2, max_seq=512)
    grads = {}
    for impl in ("flash", "reference"):
        cfg = T.TransformerConfig(**dict(small, attention_impl=impl),
                                  dtype=torch.float32)
        params = T.init_params(cfg, seed=1, param_dtype=torch.float32)
        named = named_parameters(params)
        for _, t in named:
            t.requires_grad_()
        batch = T.synthetic_batch(1, cfg, 2, 512)
        loss = T.loss_fn(params, batch, cfg)
        loss.backward()
        grads[impl] = (loss.item(), {n: t.grad for n, t in named})
    (lf, gf), (lr, gr) = grads["flash"], grads["reference"]
    errs = {n: ((gf[n] - gr[n]).abs().max() / gr[n].abs().max()).item()
            for n in gr}
    worst = max(errs, key=errs.get)
    log(f"model f32 (L=2, d1024, H16, kv4, seq 512, batch 2): loss flash "
        f"{lf:.7f} plain {lr:.7f}; worst gradient {worst} rel_err "
        f"{errs[worst]:.3e} tol 1e-04")
    if not (abs(lf - lr) <= 1e-5 * abs(lr) and errs[worst] <= 1e-4):
        raise AssertionError("the kernels' model gradients disagree with "
                             "the plain attention path")
    del grads, gf, gr
    torch.cuda.empty_cache()
    return {"loss_flash": lf, "loss_plain": lr, "grad_rel_err": errs}


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def profile_train_step(step, params, batch) -> dict:
    """One more step under ``torch.profiler``: device time by kernel,
    against that step's own wall time (the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = {e.key: e.self_device_time_total / 1e3
               for e in _device_events(prof)}
    busy = sum(kernels.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")

    def ms(tag):
        return sum(t for k, t in kernels.items() if tag in k)

    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms,
           "flash_fwd_ms": ms("flash_fwd_kernel"),
           "flash_bwd_dkdv_ms": ms("flash_bwd_dkdv_kernel"),
           "flash_bwd_dq_ms": ms("flash_bwd_dq_kernel"),
           "top_kernels_ms": {k[:70]: t for k, t in sorted(
               kernels.items(), key=lambda kv: -kv[1])[:10]}}
    k13 = out["flash_fwd_ms"] + out["flash_bwd_dkdv_ms"] + \
        out["flash_bwd_dq_ms"]
    out["flash_share_of_busy"] = k13 / busy
    if not any("flash_bwd_dq_kernel_mma" in k for k in kernels):
        raise AssertionError("the bf16 step did not run K3 on the tensor "
                             f"cores: {sorted(kernels)[:20]}")
    log(f"train step profile: device busy {busy:.1f} ms of {wall_ms:.1f} "
        f"ms (idle share {out['idle_share']:.3f}); K1 "
        f"{out['flash_fwd_ms']:.1f}, K2 {out['flash_bwd_dkdv_ms']:.1f}, K3 "
        f"{out['flash_bwd_dq_ms']:.1f} ms ({out['flash_share_of_busy']:.1%}"
        " of busy)")
    return out


def train_full_width() -> dict:
    """The main training path, through the entry points a user calls."""
    from horovod_tpu_torch import basics, optim, spmd
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A

    # The serving engines hold themselves in reference cycles (the
    # scheduler's callbacks): collect them, so that the peak memory
    # below is the training run's own.
    gc.collect()
    torch.cuda.empty_cache()
    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        cfg = T.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
        params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
        named = optim.named_parameters(params)
        for _, t in named:
            t.requires_grad_()
        n_params = sum(t.numel() for _, t in named)
        n_matmul = n_params - params["embed"].numel()
        opt = optim.DistributedOptimizer(
            torch.optim.AdamW([t for _, t in named], lr=3e-4,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4),
            named_parameters=named)
        step = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)
        B, S = TRAIN_BATCH, TRAIN["max_seq"]
        batch = T.synthetic_batch(0, cfg, B, S)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # The main path's run: the launch counters read 0 here and are
        # read again after the last step.
        A.flash_fwd_launches = 0
        A.flash_bwd_dkdv_launches = 0
        A.flash_bwd_dq_launches = 0
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.monotonic()
            losses.append(float(step(params, batch)))  # waits for the card
            times.append(time.monotonic() - t0)
        launches = {"flash_fwd": A.flash_fwd_launches,
                    "flash_bwd_dkdv": A.flash_bwd_dkdv_launches,
                    "flash_bwd_dq": A.flash_bwd_dq_launches}
        peak = torch.cuda.max_memory_allocated()
        step_s = statistics.median(times)
        flops = 6 * n_matmul * B * S + 6 * cfg.n_layers * B * S * S * \
            cfg.d_model
        out = {"params": n_params, "matmul_params": n_matmul,
               "losses": losses, "step_s": times, "step_s_median": step_s,
               "tokens_per_s": B * S / step_s, "step_flops": flops,
               "mfu": flops / step_s / PEAK_FLOPS[torch.bfloat16],
               "bound_step_ms": flops / PEAK_FLOPS[torch.bfloat16] * 1e3,
               "peak_mem_gb": peak / 1e9, "launches": launches}
        log(f"train losses: {[round(x, 4) for x in losses]}")
        log(f"train: {n_params} params, median step {step_s * 1e3:.1f} ms, "
            f"{out['tokens_per_s']:.0f} tok/s, MFU {out['mfu']:.4f} (bound "
            f"{out['bound_step_ms']:.1f} ms a step), peak memory "
            f"{out['peak_mem_gb']:.2f} GB, launches {launches}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"a training loss is not finite: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses}")
        want = cfg.n_layers * TRAIN_STEPS
        if any(n != want for n in launches.values()):
            raise AssertionError(f"expected {want} launches of K1, K2 and "
                                 f"K3 (one a layer a step), got {launches}")
        out["profile"] = profile_train_step(step, params, batch)
        del params, opt, step, batch
    finally:
        basics.shutdown()
    torch.cuda.empty_cache()
    return out


# --- phase 8: times ----------------------------------------------------------


def time_flash(err: float, launches: int, B: int = 2, Hkv: int = 4) -> dict:
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    H, S, D, dt = 16, 2048, 64, torch.bfloat16
    q, k, v = _k1_inputs(B, H, Hkv, S, D, dt, seed=100)
    ke, ve = A.expand_kv(k, H), A.expand_kv(v, H)
    scale = 1.0 / math.sqrt(D)
    def kernel():
        return A.flash_attention_with_lse(q, k, v, True)

    ms, one = time_ms(kernel), time_ms(kernel, batch=1)
    plain = time_ms(lambda: A._reference_attention_lse(
        q, A.expand_kv(k, H), A.expand_kv(v, H), 0, scale), reps=5, batch=1)
    try:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    except TypeError:  # a PyTorch without enable_gqa: expanded K/V
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True))
    pairs = B * H * S * (S + 1) / 2
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) \
        + 4 * B * H * S
    b_ms, b_by = bound(4 * D * pairs, nbytes, dt)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "horovod_tpu/ops/attention.py:124",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "tflops": tflops(4 * D * pairs, ms),
            "one_call_ms": one,
            "shape": f"B={B} H={H} H_kv={Hkv} S=T={S} D={D} bf16 causal"}


def time_flash_bwd(errs: dict, launches: dict) -> list:
    """K2 and K3 at the training shape; the library yardstick is the
    backward of ``scaled_dot_product_attention`` (one autograd call, dq,
    dk and dv together), so both rows carry the pair's time."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    B, H, S, D, dt = TRAIN_BATCH, 16, 2048, 64, torch.bfloat16
    scale = 1.0 / math.sqrt(D)
    q, k, v = _k1_inputs(B, H, H, S, D, dt, seed=300)
    do = torch.randn((B, H, S, D), device="cuda").to(dt)
    o, lse = A._flash_fwd_cuda(q, k, v, 0, scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, 0, scale)
    ms2 = time_ms(lambda: A._flash_bwd_dkdv_cuda(*args))
    ms3 = time_ms(lambda: A._flash_bwd_dq_cuda(*args))
    one2 = time_ms(lambda: A._flash_bwd_dkdv_cuda(*args), batch=1)
    one3 = time_ms(lambda: A._flash_bwd_dq_cuda(*args), batch=1)
    plain2 = time_ms(lambda: A._flash_bwd_dkdv_reference(*args), reps=5,
                     batch=1)
    torch.cuda.empty_cache()
    plain3 = time_ms(lambda: A._flash_bwd_dq_reference(*args), reps=5,
                     batch=1)
    torch.cuda.empty_cache()
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib = time_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                              retain_graph=True))
    pairs = B * H * S * (S + 1) / 2
    rows = 4 * B * H * S  # lse and delta, f32
    n = q.numel()
    shape = f"B={B} H={H} S=T={S} D={D} bf16 causal"
    out = []
    for name, src, line, ms, one, plain, flop_per_pair, outs in (
            ("flash_bwd_dkdv", "horovod_tpu/ops/attention.py:254", "dkdv",
             ms2, one2, plain2, 8 * D, 2),
            ("flash_bwd_dq", "horovod_tpu/ops/attention.py:315", "dq",
             ms3, one3, plain3, 6 * D, 1)):
        flops = flop_per_pair * pairs
        b_ms, b_by = bound(flops, 2 * 4 * n + 2 * rows + 2 * outs * n, dt)
        out.append({"name": name, "route": "cuda",
                    "source": "horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                    "replaces": src, "launches": launches[name],
                    "max_abs_err": errs[line], "ms": ms, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                    "tflops": tflops(flops, ms), "one_call_ms": one,
                    "shape": shape})
    del q, k, v, do, o, lse, delta, ql, kl, vl, ol
    torch.cuda.empty_cache()
    return out


def time_paged(err: float, launches: int) -> dict:
    import torch.nn.functional as F

    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import paged_attention as PA

    S, Hkv, R, Dh, ps, MP = 8, 4, 4, 64, 16, 136
    P = S * MP + 1
    g = torch.Generator(device="cuda").manual_seed(7)
    qg = torch.randn((S, Hkv, R, Dh), generator=g, device="cuda").to(
        torch.bfloat16)
    kp = torch.randn((P, Hkv, ps, Dh), generator=g, device="cuda").to(
        torch.bfloat16)
    vp = torch.randn_like(kp)
    # Every slot at full depth, each with its own pages in shuffled order.
    perm = torch.randperm(P - 1, generator=g, device="cuda")[:S * MP] + 1
    table = perm.reshape(S, MP).to(torch.int32).contiguous()
    limit = torch.full((S,), MP * ps, dtype=torch.int32, device="cuda")
    def kernel():
        return PA.paged_attend(qg, kp, vp, None, None, table, limit)

    # Device time (split + combine kernels): CUDA events around 10
    # back-to-back calls time the host's launching at this size.
    ms = device_ms(kernel, "paged_attend_")
    call_ms, one = time_ms(kernel), time_ms(kernel, batch=1)
    plain = time_ms(lambda: PA.paged_attend_reference(
        qg, kp, vp, None, None, table, limit), reps=10, batch=1)
    kg = T._gather_pages(kp, table)
    vg = T._gather_pages(vp, table)
    vis = (torch.arange(MP * ps, device="cuda")[None, :]
           < limit[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=vis)

    lib, lib_call = device_ms(library), time_ms(library)
    pps, grid = PA.split_grid(S, Hkv, R, MP)
    log(f"K4 grid at the serving shape: split kernel {grid} = "
        f"{math.prod(grid)} CTAs of {pps} pages, combine {grid[0]} CTAs")
    n_pos = int(limit.sum())
    kv_bytes = 2 * n_pos * Hkv * Dh * kp.element_size()
    nbytes = (kv_bytes + qg.numel() * qg.element_size() + table.numel() * 4
              + S * 4 + S * Hkv * R * Dh * 4 + S * Hkv * R * 4)
    flops = 4 * Hkv * R * Dh * n_pos
    b_ms, b_by = bound(flops, nbytes, torch.bfloat16)
    return {"name": "paged_attend", "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "horovod_tpu/ops/paged_attention.py:101",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "tflops": tflops(flops, ms),
            "one_call_ms": one, "call_ms": call_ms,
            "library_call_ms": lib_call,
            "grid": list(grid), "pages_per_split": pps,
            "shape": f"S={S} H_kv={Hkv} R={R} Dh={Dh} page={ps} "
                     f"pages/slot={MP} bf16, every slot at {MP * ps}"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import horovod_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: horovod_tpu_torch is not importable ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    card = card_info()
    build()
    REPORT["sass_hmma"] = sass_check()
    k1 = check_flash()
    k23 = check_flash_bwd()
    k4 = check_paged()
    REPORT["kernel_checks"] = {"flash_fwd": k1, "flash_bwd": k23,
                               "paged_attend": k4}
    serving = serve_full_width()
    REPORT["serving_bf16"] = serving
    ident = token_identity()
    REPORT["token_identity_f32"] = ident
    f32d, bf16d = ident["durability"], serving["durability"]
    log(f"durability on {card}: recovery s from the fault to the first "
        f"clean tick: f32 {[round(s, 4) for s in f32d['recovery_s']]}, "
        f"bf16 {[round(s, 4) for s in bf16d['recovery_s']]}; "
        f"resume_wasted_tokens f32 {f32d['resume_wasted_tokens']}, bf16 "
        f"{bf16d['resume_wasted_tokens']}; burst tok/s f32 clean "
        f"{f32d['clean_tok_per_s']:.1f} faulted "
        f"{f32d['faulted_tok_per_s']:.1f} (same engine and prompts); bf16 "
        f"serving burst {serving['tok_per_s']:.1f}, faulted and preempting "
        f"burst {bf16d['faulted_tok_per_s']:.1f}")
    REPORT["model_grads_f32"] = model_grads_f32()
    train = train_full_width()
    REPORT["train_bf16"] = train
    # K1 runs on both main paths: its launches are the two runs' sum.
    k1_launches = serving["launches"]["flash_fwd"] + \
        train["launches"]["flash_fwd"]
    kernels = [time_flash(k1["serving"], k1_launches),
               *time_flash_bwd(k23["training"], train["launches"]),
               time_paged(k4["serving"],
                          serving["launches"]["paged_attend"])]
    k1_train = time_flash(None, train["launches"]["flash_fwd"],
                          B=TRAIN_BATCH, Hkv=16)
    REPORT["flash_fwd_training_shape"] = k1_train
    for kr in kernels + [k1_train]:
        log(f"{kr['name']} [{kr['shape']}]: {kr['ms']:.4f} ms "
            f"({kr['tflops']:.1f} TFLOP/s; one call alone "
            f"{kr['one_call_ms']:.4f} ms), bound {kr['bound_ms']:.4f} ms "
            f"({kr['bound_by']}), plain {kr['plain_ms']:.4f} ms, library "
            f"{kr['library_ms']:.4f} ms")
    REPORT["kernels"] = kernels
    REPORT["seconds"] = time.monotonic() - t_start
    log("report: " + json.dumps(REPORT, default=str))
    log(f"card: {card}")
    print(json.dumps({"kernels": [
        {k: v for k, v in kr.items()
         if k not in ("shape", "grid", "pages_per_split", "call_ms",
                      "library_call_ms")}
        for kr in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
