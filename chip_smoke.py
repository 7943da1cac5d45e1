#!/usr/bin/env python3
"""Drive horovod_tpu_torch's serving, training and vision paths on one
NVIDIA GPU and check them.

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
   past the limit, R = 1 and 8, and the speculative verify's R = 20 in
   f32, bf16 and int8 -> bf16), each case called twice and required
   to agree bit for bit; flash-attention backward (K2 dk/dv, K3 dq)
   through the autograd Function with a nonzero lse cotangent, bf16 and
   f32, head_dim 64 and 128, S 8, 100 and 2048, causal, full and shifted
   masks, MHA and GQA (G = 4), against the plain backward on the same
   forward.
   Edge shapes for K1-K3 in both dtypes: ragged S (1, 17, 63, 65,
   2047) and S = 100 against T = 300, unmasked, bottom-right causal
   (shift = S - T) and fully masked (shift = T - S); K1 also at the
   resume bucket, S = 2176 (``max_len``), B = 2, and at the suffix
   shapes of ``prefill_with_prefix`` (``SUFFIX_SHAPES``: S0 queries
   over T = p0 + S0 keys, shift = -p0), B = 2, H = 16, H_kv = 4; at the
   suffix shapes also with the shift read from device memory (the
   captured suffix prefills' mode), against the plain version and bit
   for bit against the by-value shift.
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
   ``InferenceEngine`` + ``ServingServer``, warmed over every prompt
   bucket (``ENGINE_WARM_LENS``: each admission graph ``("full", bucket,
   k)`` and ``("sample", k)`` captured, the captures' count, seconds
   and the device memory reserved around the sweep printed): 8
   concurrent ``POST /generate`` requests, half greedy and half
   sampled with fixed seeds, whose prompts cover the buckets 8..2048.
   Every request must return
   its full token count, both kernels' launch counters must grow during
   the run, ``decode_compilations`` must read 1 before and after, and
   ``prefill_compilations`` and ``sample_compilations`` must not grow
   past the warmups over the prefix runs and the burst.
   Then durability in bf16: the same prompts on a pool of
   ``DURABLE_PAGES`` pages, below capacity parity, so that decode growth
   suspends requests, and a decode tick raising midway through the
   burst: every request returns its full count, with at least one
   preemption and one resume, one restart, an empty journal and one
   capture; then the graph check again on the restarted engine (its pool
   reset in place).
   Shared prefixes, on the same engine before its HTTP burst: a registered
   ``PREFIX_LEN``-token prefix (its last page partial) and eight
   requests, six sharers with suffixes of 16-512 tokens and a greedy
   and a sampled one whose prompt is the prefix, after a warmup of the
   prefix's suffix graphs (``PREFIX_SUFFIXES`` as the suffix lengths).
   Every request returns its full count; the only whole-prompt
   prefill is the prefix's (the
   sharers prefill their suffixes only, the prefix prompts nothing);
   ``kv_pages_shared`` is above 0 while they decode; after
   ``unregister_prefix`` the pool is whole; one capture.  Then the same
   prompts with nothing registered; both runs' tok/s, TTFT p50 and
   prefill tokens are printed with the card.  An admission profile:
   one group of two prompts at bucket 2048 and one at bucket 16, each
   admitted alone: host wall, device busy and kernel count
   (``torch.profiler``), and the time from ``_admit_batch``'s entry to
   the replay and to its first-token sync: the captured path, one
   prefill replay.  Then the SLO leg of ``benchmarks/serving.py`` (two
   waves of two long batch prompts and six short interactive
   ones; 4 slots, K = 2) on fresh engines driven by their own thread:
   ``slo`` (chunks of 32 tokens, priority classes) and ``fcfs``
   (whole-prompt prefill, one class), each warmed over the buckets its
   prompts and their resumes reach, each request its full count, one
   capture of the tick and none of admission past the warmup; per-class
   TTFT p50/p99, tok/s and preemptions printed.
   Then tracing (``tracing_full_width``), on one engine of the same
   configuration warmed over ``ENGINE_WARM_LENS`` with
   ``model_flops_per_token`` from ``obs.xprof``: the eight prompts,
   greedy, stepped with a request tracer and a span recorder on and one
   decode tick raising once each has a token (its live journal entries
   name the requests' span ids; each interrupted request's span gets
   ``engine_restart`` then ``resume``); ``Timeline.profile`` over
   ``TRACE_PROFILE_TICKS`` captured ticks at 8 slots, whose Chrome trace
   must name K4's split and combine kernels a launch each a layer a
   tick, merged by ``obs.merge`` with the host timeline into one file
   holding both; then four HTTP bursts of the eight greedy prompts
   (``TRACE_LEGS``: untraced, traced, traced, untraced; each queued in a
   fixed order with the engine held, so that every leg schedules alike),
   requests 0 and 1 carrying ``X-Trace-Id`` with ``X-Parent-Span`` and
   with ``X-Trace-Sampled``: tokens, ticks and host syncs a tick equal
   across the legs, no capture in any, K1 and K4 launched in each; in
   each traced leg one start and one finish record a request, a trace
   tree rooted at each request's span (request 0's under the given
   parent), request 1's tick detail kept and the others' dropped, each
   breakdown summing to its total within 1 ms; a ``/metrics`` scrape
   read by a strict parser, ``serving_achieved_flops_per_sec`` above 0
   and ``xla_compiles_total{fn="serving_decode"}`` up by the engine's
   decode captures; then ``TRACE_TRAIN_STEPS`` captured LM training
   steps inside ``obs.training_step`` with a timeline started: one
   ``train_step`` span a step, ``training_steps_total`` up by as many.
   Printed with the card: each leg's tok/s, median decode step, host
   syncs a tick, span lines and JSONL bytes a request.
   Then the serving fleet (``fleet_full_width``): the serving
   configuration's weights (``init_params`` seed 0) written by
   ``replica_main.dump_model``, ``FLEET_REPLICAS`` replica processes on
   the one card (each its own CUDA context, warmed over
   ``FLEET_WARM_LENS``, the buckets the prompts and their resumes reach)
   under ``ReplicaSupervisor`` (journals, span streams, logs) behind
   ``RouterServer`` with ``resume_lookup``; the replicas' seconds from
   spawn to routable, their ``warmup_reserved_bytes`` beside
   ``nvidia-smi``'s memory used.  Three legs, in bf16: the eight serving
   prompts concurrently (every reply 200 with its full count, both
   replicas answering; in each replica K1's and K4's counters grow, one
   tick capture, no admission capture after warmup; router tok/s and
   TTFT beside the serving phase's single-engine burst); the same burst
   with one replica SIGKILLed once every request has tokens (full
   counts, a ``resumed`` reply, ``router_resume_failovers_total`` >= 1,
   the slot respawned and back in rotation, ``GET /trace/<id>`` of a
   resumed request one tree with the killed attempt's unfinished span
   and the journal's resume edge; kill to last reply, kill to rejoin and
   the re-prefilled tokens printed); ``POST /rollout`` of
   ``FLEET_CANDIDATE`` under back-to-back bursts (the rollout ``done``,
   every replica at ``config_generation`` 1, no request dropped; its
   duration and steps printed).  A failed gate prints every replica
   log's tail.
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
   own: K1 and K4 must launch during it.  Then, on the same engine, a
   registered prefix with three sharers and one request whose prompt is
   the prefix, and the ``slo`` leg in f32 through one ``prefill_chunk``
   fault at a chunk boundary (one restart, ``healthy`` at the end): the
   tokens of both against ``greedy_decode`` / ``sample_decode`` of the
   whole prompt, by the same near-tie rule.
   Speculative decoding in f32, on the same prompts: an engine with
   ``speculative=True`` for each draft source (``SPEC_DRAFTS``: n-gram
   prompt lookup, the target as its own draft, and a half-depth draft
   made of the target's first four layers, its embedding, final norm
   and head): its tokens must equal the plain engine's and the oracles'
   by the same near-tie rule, the self-draft's acceptance must reach
   0.9 with more than one token a tick, and one decode fault mid-burst
   must leave the tokens equal to the oracles (one restart, two
   captures, an empty journal).
   The f32 fleet (``fleet_identity_f32``, TF32 off in the replicas,
   PyTorch's default): two replicas serve the same prompts, half
   sampled, one SIGKILLed once every request has tokens; every reply,
   resumed ones included, equals the oracles by the same near-tie rule.
   Then an f32 engine in this process with ``autotune=True`` and
   ``FLEET_TUNER_WINDOW``-tick scoring windows serves bursts of them
   until its tuner has applied ``FLEET_TUNER_APPLIES`` settings: the
   tokens equal the oracles, and no graph is captured after warmup.
6. Speculative decoding at full width in bf16 (``spec_legs``): for each
   draft source a speculative engine against the plain one on the same
   8 prompts, interleaved repetitions, tok/s over full-occupancy steps
   (``benchmarks/serving.py``'s ``_ab_spec``), acceptance, tokens a
   tick, each graph's replays, the step's wall and device time
   (profiler); the n-gram leg on the random-init target is the losing
   case, where the adaptive control must disable the slots and fall back
   to the plain graph.  Then an HTTP burst through ``ServingServer``
   (half sampled, one opted out): full counts, ``decode_compilations``
   2 before and after, no admission capture past the warmup.
7. Collectives: a size-1 NCCL group, every collective of the port
   (each allreduce op with and without pre/postscale, compression,
   grouped Average and Adasum, allgather, broadcast, alltoall even and
   with splits, reducescatter, hierarchical allreduce and allgather,
   every ``*_async`` with ``poll`` and one ``synchronize``, sparse
   against dense, the object collectives, ``join``, ``masked_average``
   at active 0 and 1) on CUDA tensors in f32 and bf16: each result must
   equal its size-1 value exactly.
8. Model gradients: a 2-layer d1024 model's f32 loss and parameter
   gradients through the kernels against the plain attention path, and
   with remat ``full`` and ``dots`` against no remat (TF32 off).
9. Training at full width: a size-1 NCCL process group, then four legs
   of 10 data-parallel steps (``spmd.make_train_step`` +
   ``DistributedOptimizer(AdamW)``) of the d1024/L8/H16 MHA model with
   f32 master parameters and bf16 compute on one fixed batch of 8 x 2048
   tokens, from the same parameters: eager (the step's eager body),
   remat ``full``, remat ``dots`` and captured (two eager warm-up
   steps, one CUDA graph capture, replays).  Every loss must be finite,
   the last below the first; K1 must launch once a layer a step (twice
   under remat), K2 and K3 once, also under the graph; the remat and
   captured legs' losses must equal the eager leg's within 1e-3
   relative a step, and each remat leg's peak memory must be below the
   eager leg's.  Each leg prints its step time, tokens/s, MFU on useful
   FLOP, peak memory and launches, and one more step is profiled
   (device busy, idle share; its K3 must be the tensor-core
   ``flash_bwd_dq_kernel_mma``).
10. Vision (``vision_full_width``), no kernel of the port: full ResNet-50
   in f32 (batch 4, 224², TF32 off) on CUDA against the same model and
   weights on the CPU (logits, loss, every gradient, the batch
   statistics; the ``s2d`` stem one forward), each error beside its
   tolerance; then on a size-1 NCCL group the bf16 channels_last legs
   in ``horovod_tpu_torch.bench``'s protocol (10 warm-up batches, 10 ×
   10 timed, ``cudnn.benchmark`` on): batch 384 eager and captured (with
   the loader-fed A/B and a profiled step each), batch 64 eager,
   captured and captured with bf16 gradient reduction, each from
   ``init_variables`` seed 0 on one batch, with img/s, MFU from
   ``obs.xprof``'s FLOP count and peak memory; before them the first 10
   losses at batch 64 of the eager and captured step under
   ``cudnn.deterministic`` within 1e-3 relative; InceptionV3 (299², batch
   64, captured, 3 × 10 timed) and the MLP (20 loader-fed captured
   steps).  Every loss finite and the last below the first, one capture
   a captured leg with every later call a replay, MFU in (0, 1).
11. Times: each kernel at its path's shape (CUDA events around 10
   back-to-back calls, median of 20; also one call alone, which adds
   the host's launch cost; K4 and its yardstick, whose calls are
   shorter than their launching, by the profiler's device time) beside
   its bound, its achieved TFLOP/s (the bound's FLOP count over its
   time), its plain version and a PyTorch yardstick the port never
   calls, and K4's split grid; the serving run's decode tok/s, TTFT and
   per-tick time.  K1 also at the prefix phase's suffix shape, by value
   and with the shift read from device memory, SDPA with the same mask
   as a boolean ``attn_mask`` its yardstick.  K4 also at the verify's
   R = 20 (8 slots x 2176 positions; K4 at R = 4 timed beside it, SDPA
   over the gathered K/V at R = 20 its yardstick), its own entry in the
   kernels line with the verify launches of the speculative legs.

Each phase's seconds are printed as it ends.

A ``report:`` line carries every measurement as JSON; the line before
last is a JSON object of the kernels (each one's launches summed over
the main paths' runs that launch it: the HTTP burst, the prefix run,
the two SLO legs, the speculative legs, the tracing phase's four
bursts, the fleet's clean burst in both replicas and its SIGKILL burst
in the survivor (read from each replica's ``/stats``), the four
training legs and the traced training steps;
K4's verify calls at R = 20 in an entry of their own); the last line is
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
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores and HBM3 bandwidth; the bf16 tensor-core peak is read from
# horovod_tpu_torch.obs.xprof's table in main().
PEAK_FLOPS = {torch.float32: 67e12}
H100 = "NVIDIA H100 80GB HBM3"
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
# One prompt length in each prefill bucket of ENGINE, 8 to 2048 and 2176
# (max_len, which a resumed long prompt reaches): the serving, durability
# and f32 engines' warmup captures the whole-prompt graphs of all of them.
ENGINE_WARM_LENS = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 2170]
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
# The shared-prefix phase: a registered prefix of PREFIX_LEN tokens (not a
# multiple of the page size 16, so its partial last page is copied on
# write), six sharers with suffixes of PREFIX_SUFFIXES tokens, then a
# greedy and a sampled request whose prompt is the prefix.
PREFIX_LEN = 1000
PREFIX_SUFFIXES = [16, 40, 100, 200, 300, 512]
PREFIX_NEW_TOKENS = 64
PREFIX_SAMPLING = SAMPLING[:6] + [{}, dict(temperature=0.9, top_k=50,
                                           seed=5)]
# The SLO leg of benchmarks/serving.py (_slo_mode): two waves 0.25 s
# apart, each two long batch prompts of 240-288 tokens, then six
# interactive prompts of 3-12 tokens 10 ms apart; 16 new tokens each;
# 4 slots, K = 2, chunks of 32 tokens.
SLO_LONG, SLO_CHUNK, SLO_NEW_TOKENS = 288, 32, 16
SLO_ENGINE = dict(n_slots=4, max_len=SLO_LONG + 2 * SLO_NEW_TOKENS + 32,
                  max_prefills_per_tick=2, page_size=16, max_queue_depth=64)
# The f32 SLO leg's fault: the prefill_chunk visit after this many more.
SLO_FAULT_SKIP = 5
# The speculative phase (EngineConfig's default spec_k = 4: W = 5, the
# verify's K4 at R = G * W = 20).  The bf16 legs, after benchmarks/
# serving.py's _ab_spec: 8 prompts of SPEC_PROMPT_LEN tokens, each leg's
# speculative engine against the plain one on them, SPEC_NEW_TOKENS
# tokens a request, SPEC_REPS measured repetitions after a warm one;
# tok/s over full-occupancy steps.  The f32 legs' decode fault fires once
# the burst has emitted SPEC_FAULT_AT tokens.
SPEC_K = 4
SPEC_PROMPT_LEN, SPEC_NEW_TOKENS, SPEC_REPS = 64, 128, 2
SPEC_FAULT_AT = 64
SPEC_DRAFTS = ("ngram", "self", "half")

REPORT: dict = {"phase_s": {}}


def log(msg: str) -> None:
    print(msg, flush=True)


class phase:
    """Times a phase into ``REPORT["phase_s"]`` and prints its seconds."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        dt = time.monotonic() - self.t0
        REPORT["phase_s"][self.name] = dt
        log(f"phase {self.name}: {dt:.1f} s")


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
    # A profiler session on an H100 has come back with no device event
    # at all (once, for the SDPA yardstick beside K4, which other runs
    # profile fine): such a session is logged with what it did record
    # (the CPU-side runtime calls, such as cudaLaunchKernel, show
    # whether the launches were seen while their kernels' records were
    # not) and profiled again, twice at most.
    from torch.autograd import DeviceType

    name = getattr(fn, "__qualname__", repr(fn))
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        total = sum(e.self_device_time_total for e in events if tag in e.key)
        if total > 0:
            return total / 1e3 / reps
        if events:
            break
        host = [e for e in prof.key_averages()
                if e.device_type != DeviceType.CUDA]
        log(f"device_ms: profiler session {attempt + 1} of 3 for {name} "
            f"(tag {tag!r}) recorded no device event and "
            f"{sum(e.count for e in host)} CPU-side events "
            f"{sorted({e.key for e in host})[:8]}; profiling again")
    raise AssertionError(f"the profiler saw no kernel matching {tag!r} "
                         f"for {name}")


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
# K1 as prefill_with_prefix calls it, (p0, S0): S0 suffix queries over
# T = p0 + S0 keys with shift = -p0 (the bottom-right causal mask) — the
# prefix phase's shape, a prefix on no page or key-block boundary, a
# tiny one, the chunk shape, and the last chunk of a 2048-token prompt.
SUFFIX_SHAPES = ((1024, 512), (1000, 256), (15, 16), (32, 32), (2016, 32))


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
    cases += [(dt, 64, S0, p0 + S0, "bottom_right") for dt in dts
              for p0, S0 in SUFFIX_SHAPES]
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
        if dt == torch.bfloat16 and (T - S, S) == SUFFIX_SHAPES[0]:
            worst["suffix"] = err
        worst[name] = err
    # The device shift at the suffix shapes: the key buffer padded past
    # p0 + S0 with junk, as the captured suffix prefill's is.
    for i, (dt, (p0, S0)) in enumerate((dt, sh) for dt in dts
                                       for sh in SUFFIX_SHAPES):
        B, H, Hkv, D = 2, 16, 4, 64
        T = p0 + S0 + 64
        q, k, v = _k1_inputs(B, H, Hkv, S0, D, dt, seed=500 + i, T=T)
        shift = torch.tensor(-p0, dtype=torch.int32, device="cuda")
        o, lse = A.flash_attention_shifted(q, k, v, shift)
        o_v, lse_v = A.flash_attention_shifted(q, k, v, -p0)
        o_r, l_r = A._reference_attention_lse(
            q, A.expand_kv(k, H), A.expand_kv(v, H), -p0, 1.0 / math.sqrt(D))
        torch.cuda.synchronize()
        err = max((o.float() - o_r.float()).abs().max().item(),
                  (lse - l_r).abs().max().item())
        same = torch.equal(o, o_v) and torch.equal(lse, lse_v)
        name = (f"K1 device shift {str(dt)[6:]} D={D} S={S0} T={T} "
                f"shift={-p0}")
        log(f"{name}: max_abs_err={err:.3e} tol={tol[dt]:.0e}, "
            f"bit-identical to the by-value shift: {same}")
        if not (err <= tol[dt] and same):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 "or with the by-value shift")
        if dt == torch.bfloat16 and (p0, S0) == SUFFIX_SHAPES[0]:
            worst["suffix_device_shift"] = err
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
             (f32, f32, 128, 8, K4_SPLIT_LIMITS, 1e-4),
             # The speculative verify: R = G * W = 4 * 5.
             (f32, f32, 64, 20, K4_LIMITS, 1e-4),
             (bf16, bf16, 64, 20, K4_LIMITS, 2e-2),
             ("int8", bf16, 64, 20, K4_LIMITS, 2e-2)]
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
        if kind == bf16 and Dh == 64 and R == 20:
            worst["verify"] = err
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


def serve_full_width(card: str) -> dict:
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
    t0 = time.monotonic()
    engine.warmup(ENGINE_WARM_LENS)
    warm_s = time.monotonic() - t0
    warm_graphs = _admission_graphs(engine)
    reserved = warm_graphs["warmup_reserved_bytes"]
    log(f"admission graphs on {card}: warmup over buckets 8-2176 in "
        f"{warm_s:.3f} s; {warm_graphs['prefill_compilations']} prefill "
        f"and {warm_graphs['sample_compilations']} sampler captures in "
        f"{warm_graphs['prefill_capture_s']:.3f} s; reserved "
        f"{reserved[0]} -> {reserved[1]} bytes across the sweep "
        f"(+{(reserved[1] - reserved[0]) / 2**20:.1f} MiB, the tick's "
        f"capture included); buckets {engine.stats()['prefill_buckets']}")
    captures0 = engine.stats()["decode_compilations"]
    modes.append(profile_decode(engine, "graph_overlap",
                                sampler["sampler_ms"]))
    sampler["share_of_tick_busy"] = modes[-1]["sampler_share_of_busy"]
    # The prefix phase and the admission profile step the engine
    # directly, before the HTTP burst (stopping the server drains it).
    with phase("prefix_bf16"):
        prefix = prefix_full_width(engine, card)
    with phase("admission_profile"):
        admission = admission_profile(engine)
    graphs0 = _admission_graphs(engine)
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
    graphs1 = _admission_graphs(engine)
    if graphs1 != graphs0:
        raise AssertionError(f"the burst captured admission graphs: "
                             f"{graphs0} before, {graphs1} after")
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
        "graph_vs_eager": check, "warmup_s": warm_s,
        "admission_graphs_after_warmup": warm_graphs,
        "admission_graphs_after_burst": graphs1,
        "prefill_buckets": stats["prefill_buckets"],
    }
    log(f"serving bf16: {len(prompts)} requests (half sampled), {total} "
        f"tokens in {wall:.3f} s = {out['tok_per_s']:.1f} tok/s; {ticks} "
        f"decode ticks at {out['tick_ms_mean']:.3f} ms; TTFT p50 "
        f"{out['ttft_ms_p50']:.1f} ms max {out['ttft_ms_max']:.1f} ms; "
        f"launches {launches}; decode_compilations before/after "
        f"{captures}; admission graphs {graphs1} (none captured during the "
        f"burst); sampler {sampler['share_of_tick_busy']:.1%} of the "
        "graph tick's device busy")
    out["prefix"], out["admission_profile"] = prefix, admission
    del engine
    torch.cuda.empty_cache()
    with phase("durability_bf16"):
        out["durability"] = durability_bf16(params, cfg)
    with phase("slo_bf16"):
        out["slo"] = {}
        for slo in (True, False):
            leg = slo_leg(params, cfg, slo)
            del leg["prompts"], leg["tokens"]
            out["slo"][leg["leg"]] = leg
    slo_, fcfs = out["slo"]["slo"], out["slo"]["fcfs"]
    log(f"SLO legs on {card}: interactive TTFT p50/p99 slo "
        f"{slo_['interactive_ttft_ms_p50']:.1f}/"
        f"{slo_['interactive_ttft_ms_p99']:.1f} ms vs fcfs "
        f"{fcfs['interactive_ttft_ms_p50']:.1f}/"
        f"{fcfs['interactive_ttft_ms_p99']:.1f} ms; batch slo "
        f"{slo_['batch_ttft_ms_p50']:.1f}/{slo_['batch_ttft_ms_p99']:.1f} "
        f"vs fcfs {fcfs['batch_ttft_ms_p50']:.1f}/"
        f"{fcfs['batch_ttft_ms_p99']:.1f} ms; tok/s slo "
        f"{slo_['tok_per_s']:.1f} vs fcfs {fcfs['tok_per_s']:.1f}; "
        f"preemptions {slo_['preemptions']} / {fcfs['preemptions']}")
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
    engine.warmup(ENGINE_WARM_LENS)
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


def _f32_oracles(params, cfg, prompts, sampling=SAMPLING,
                 new_tokens=F32_NEW_TOKENS) -> list:
    """Each request's oracle tokens and top-2 margins: ``greedy_decode``
    for greedy requests, ``sample_decode`` at the request's seed for
    sampled ones (``sampling[i]`` is request ``i``'s)."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving import seed_key

    refs = []
    for i, p in enumerate(prompts):
        kw = dict(sampling[i])
        prompt = torch.tensor([p], device="cuda")
        if kw:
            ref, gap = T.sample_decode(params, prompt, new_tokens, cfg,
                                       rng=seed_key(kw.pop("seed")),
                                       margins=True, **kw)
        else:
            ref, gap = T.greedy_decode(params, prompt, new_tokens, cfg,
                                       margins=True)
        refs.append((ref[0].tolist(), gap[0].tolist()))
    return refs


def _check_f32(label: str, prompts, outs, refs, sampling=SAMPLING) -> list:
    """Every request's tokens (``outs``) against its oracle.  A mismatch
    is exempt only at or after a pick whose oracle top-2 gap is below
    ``NEAR_TIE``; returns the exemptions."""
    exempt = []
    for i, (p, got, (ref, gap)) in enumerate(zip(prompts, outs, refs)):
        if got == ref:
            continue
        first = next((j for j in range(len(ref))
                      if j >= len(got) or got[j] != ref[j]), len(ref))
        ties = [j for j in range(min(first + 1, len(ref)))
                if gap[j] < NEAR_TIE]
        if len(got) != len(ref) or not ties:
            raise AssertionError(
                f"{label} request {i} (prompt {len(p)}, "
                f"{sampling[i] or 'greedy'}, {len(got)} tokens) diverges "
                f"from the oracle at token {first}")
        exempt.append({"request": i, "prompt_len": len(p),
                       "sampled": bool(sampling[i]),
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


def _durability_checks(label: str, engine, launches: dict, restarts: int,
                       captures: int = 1):
    """What every faulted burst must leave: the expected restarts, an
    empty journal, a healthy engine, its decode captures (one, two for a
    speculative engine), and both kernels of the path launched during
    the burst."""
    st = engine.stats()
    got = (st["engine_restarts"], st["journal_inflight"], st["state"],
           st["decode_compilations"])
    if got != (restarts, 0, "healthy", captures):
        raise AssertionError(
            f"{label}: (engine_restarts, journal_inflight, state, "
            f"decode_compilations) = {got}, expected "
            f"({restarts}, 0, 'healthy', {captures})")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"{label}: the faulted burst missed a kernel: "
                             f"{launches}")
    return st


#: token_identity's prompts, oracles, f32 parameters and config, kept
#: for the f32 fleet leg and dropped after it.
F32_ORACLE: dict = {}


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
    engine.warmup(ENGINE_WARM_LENS)
    prompts = _prompts(seed=1)
    t0 = time.monotonic()
    futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS, **SAMPLING[i])
            for i, p in enumerate(prompts)]
    while not all(f.done() for f in futs):
        engine.step()
    torch.cuda.synchronize()
    clean_s = time.monotonic() - t0
    refs = _f32_oracles(params, cfg, prompts)
    plain_outs = [f.result(timeout=0) for f in futs]
    exempt = _check_f32("f32", prompts, plain_outs, refs)
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
    fault_exempt = _check_f32("f32 faulted", prompts,
                              [f.result(timeout=0) for f in futs], refs)
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
    # The f32 fleet leg (beside this phase) serves the same prompts
    # against the same oracles.
    F32_ORACLE.update(prompts=prompts, refs=refs, params=params, cfg=cfg)
    with phase("prefix_f32"):
        prefix = prefix_identity_f32(engine, params, cfg)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    with phase("slo_f32"):
        slo = slo_identity_f32(params, cfg)
    with phase("spec_f32"):
        spec = spec_identity_f32(params, cfg, prompts, refs, plain_outs)
    del params
    torch.cuda.empty_cache()
    return {"requests": len(prompts), "exemptions": exempt,
            "durability": faulted, "prefix": prefix, "slo": slo,
            "speculative": spec}


# --- shared prefixes, chunked prefill, the admission profile -----------------


def _prefix_prompts(seed: int):
    """The prefix phase's prefix and its eight prompts (six sharers, then
    the prefix itself twice)."""
    rng = np.random.default_rng(seed)
    V = FULL["vocab_size"]
    prefix = rng.integers(0, V, PREFIX_LEN).tolist()
    prompts = [prefix + rng.integers(0, V, n).tolist()
               for n in PREFIX_SUFFIXES]
    return prefix, prompts + [list(prefix), list(prefix)]


class _PrefillCounter:
    """The engine's prefills while entered: each replay of a whole-prompt
    graph (``prefill``) and of a suffix graph (``prefill_with_prefix``),
    with its padded and real token counts, read from the host arrays the
    engine uploads (no host sync)."""

    def __init__(self, engine):
        self.engine = engine

    def __enter__(self):
        self.calls = []
        replay = self.engine._replay

        def call(key, fields):
            name = "prefill" if key[0] == "full" else "prefill_with_prefix"
            self.calls.append((name, int(np.size(fields["tokens"])),
                               int(np.sum(fields["lens"]))))
            return replay(key, fields)

        self.engine._replay = call
        return self

    def __exit__(self, *exc):
        del self.engine._replay

    def summary(self, into: dict = None) -> dict:
        out = {} if into is None else into
        for name, padded, tokens in self.calls:
            d = out.setdefault(name, {"calls": 0, "tokens": 0,
                                      "padded_tokens": 0})
            d["calls"] += 1
            d["tokens"] += tokens
            d["padded_tokens"] += padded
        return out


def _admission_graphs(engine) -> dict:
    """The engine's admission-graph counts: captures of prefills and of
    the first-token sampler, their seconds, the device memory reserved
    before and after the last warmup, and the prefill shapes used."""
    st = engine.stats()
    out = {k: st[k] for k in ("prefill_compilations", "sample_compilations",
                              "prefill_capture_s", "warmup_reserved_bytes",
                              "decode_compilations")}
    out["prefill_shapes_used"] = (len(st["prefill_buckets"])
                                  + len(st["prefill_suffix_shapes"]))
    return out


def _warm_lens(engine, lens) -> list:
    """One length for each prefill bucket that prompts of ``lens`` and
    their resumes (up to ``SLO_NEW_TOKENS`` tokens longer) reach: the
    longest in each."""
    longest = {}
    for n in lens:
        for m in range(n, n + SLO_NEW_TOKENS + 1):
            b = engine._bucket(m)
            longest[b] = max(longest.get(b, 0), m)
    return sorted(longest.values())


def _stepped_burst(engine, prompts, sampling, new_tokens) -> dict:
    """Submit every prompt at once and step the engine until each has
    returned its full count: wall, tok/s, TTFT and the most pages shared
    at once (the ``kv_pages_shared`` gauge after each step)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    futs = [engine.submit(p, max_new_tokens=new_tokens, **sampling[i])
            for i, p in enumerate(prompts)]
    shared = 0
    while not all(f.done() for f in futs):
        engine.step()
        shared = max(shared, engine.metrics.kv_pages_shared.value)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for i, f in enumerate(futs):
        got = f.result(timeout=0)
        if len(got) != new_tokens or f.finish_reason != "length":
            raise AssertionError(f"request {i} returned {len(got)} tokens "
                                 f"({f.finish_reason})")
    ttft = sorted(f.ttft for f in futs)
    return {"wall_s": wall, "tok_per_s": len(futs) * new_tokens / wall,
            "ttft_ms_p50": statistics.median(ttft) * 1e3,
            "ttft_ms_max": ttft[-1] * 1e3, "pages_shared_max": shared,
            "tokens": [f.result(timeout=0) for f in futs]}


def prefix_full_width(engine, card: str) -> dict:
    """The serving engine (bf16, full width, warmed) with one registered
    ``PREFIX_LEN``-token prefix and eight requests: six sharers, a greedy
    and a sampled one whose prompt is the prefix.  Every request must
    return its full count, the prefix must be prefilled exactly once
    (one whole-prompt prefill, of the prefix; the sharers only their
    suffixes; the prefix prompts none), pages must be shared while they
    decode, the pool must be whole again after ``unregister_prefix``,
    and the tick captured once.  Then the same prompts with nothing
    registered, for comparison.  The prefix's suffix graphs are warmed
    between its registration and the first run, and neither run may
    capture an admission graph."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA

    prefix, prompts = _prefix_prompts(seed=5)
    n_pages = engine.slots.n_pages
    with _PrefillCounter(engine) as counted:
        t0 = time.monotonic()
        engine.register_prefix(prefix)
        torch.cuda.synchronize()
        register_s = time.monotonic() - t0
    # The prefix's suffix graphs, captured before the timed run (the JAX
    # warmup compiles a registered prefix's suffix prefills).
    t0 = time.monotonic()
    engine.warmup(PREFIX_SUFFIXES)
    warm_s = time.monotonic() - t0
    graphs = _admission_graphs(engine)
    # The prefix path's run: the launch counters read 0 here and are
    # read again after its last request.
    A.flash_fwd_launches = 0
    PA.paged_attend_launches = 0
    with _PrefillCounter(engine) as run_counted:
        shared = _stepped_burst(engine, prompts, PREFIX_SAMPLING,
                                PREFIX_NEW_TOKENS)
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches}
    pinned_free = engine.slots.free_pages
    engine.unregister_prefix(prefix)
    engine.drain(timeout=60)
    free_after = engine.slots.free_pages
    prefills = run_counted.summary(counted.summary())
    want_full = {"calls": 1, "tokens": PREFIX_LEN,
                 "padded_tokens": engine._bucket(PREFIX_LEN)}
    if prefills.get("prefill") != want_full:
        raise AssertionError(f"the prefix was not prefilled exactly once: "
                             f"{prefills}")
    if prefills["prefill_with_prefix"]["tokens"] != sum(PREFIX_SUFFIXES):
        raise AssertionError(f"the sharers prefilled more than their "
                             f"suffixes: {prefills}")
    if shared["pages_shared_max"] < 1:
        raise AssertionError("no page was shared while the sharers decoded")
    pin = engine.slots.pages_for(PREFIX_LEN)
    if (pinned_free, free_after) != (n_pages - pin, n_pages):
        raise AssertionError(f"free pages {pinned_free} pinned, {free_after} "
                             f"after unregister; expected {n_pages - pin} "
                             f"and {n_pages}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"the prefix run missed a kernel: {launches}")
    with _PrefillCounter(engine) as counted:
        plain = _stepped_burst(engine, prompts, PREFIX_SAMPLING,
                               PREFIX_NEW_TOKENS)
    plain_prefills = counted.summary()
    after = _admission_graphs(engine)
    if after != graphs:
        raise AssertionError(f"the prefix runs captured past the warmup: "
                             f"{graphs} before, {after} after")
    same = sum(a == b for a, b in zip(shared.pop("tokens"),
                                      plain.pop("tokens")))
    out = {"prefix_len": PREFIX_LEN, "suffixes": PREFIX_SUFFIXES,
           "new_tokens": PREFIX_NEW_TOKENS, "register_s": register_s,
           "shared": shared, "plain": plain, "prefills": prefills,
           "plain_prefills": plain_prefills, "launches": launches,
           "pinned_pages": pin, "requests_equal_to_plain_run": same,
           "suffix_warmup_s": warm_s, "admission_graphs": graphs,
           "suffix_shapes": engine.stats()["prefill_suffix_shapes"]}
    log(f"prefix bf16 on {card}: {PREFIX_LEN}-token prefix registered in "
        f"{register_s:.3f} s; shared {shared['tok_per_s']:.1f} tok/s, TTFT "
        f"p50 {shared['ttft_ms_p50']:.1f} ms, prefill tokens "
        f"{sum(d['tokens'] for d in prefills.values())} "
        f"({prefills}), pages shared up to {shared['pages_shared_max']:.0f}"
        f"; nothing registered {plain['tok_per_s']:.1f} tok/s, TTFT p50 "
        f"{plain['ttft_ms_p50']:.1f} ms, prefill tokens "
        f"{sum(d['tokens'] for d in plain_prefills.values())}; "
        f"{same}/8 requests token-equal across the runs (bf16); launches "
        f"{launches}; suffix graphs warmed in {warm_s:.3f} s, admission "
        f"graphs {graphs} before and after both runs")
    return out


def admission_profile(engine) -> dict:
    """One admission group of k = 2 prompts at bucket 2048 and one at
    bucket 16 on the warmed bf16 engine (one replay of its captured
    ``("full", bucket, 2)`` graph each), each admitted alone
    (``_admit_pending``, no decode tick): its host wall (the admission
    and a device sync), the time from ``_admit_batch``'s entry to the
    replay and to the return of its first-token sync, and, from a second
    admission under
    ``torch.profiler``, its device busy time and kernel count.  Each
    bucket runs once unmeasured first."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(8)
    marks = {}
    admit, first = engine._admit_batch, engine._first_tokens
    replay = engine._replay

    def timed_admit(reqs):
        marks["entry"] = time.monotonic()
        return admit(reqs)

    def timed_replay(key, fields):
        marks["replay"] = time.monotonic()
        return replay(key, fields)

    def timed_first(*args):
        toks = first(*args)
        marks["sync"] = time.monotonic()
        return toks

    engine._admit_batch, engine._first_tokens = timed_admit, timed_first
    engine._replay = timed_replay
    out = {}
    try:
        for n in (2048, 16):
            rec = {"bucket": engine._bucket(n), "k": 2}
            for mode in ("warm", "timed", "profiled"):
                futs = [engine.submit(
                    rng.integers(0, FULL["vocab_size"], n).tolist(),
                    max_new_tokens=2) for _ in range(2)]
                calls = engine.stats()["prefill_calls"]
                marks.clear()
                torch.cuda.synchronize()
                t0 = time.monotonic()
                if mode == "profiled":
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        engine._admit_pending()
                        torch.cuda.synchronize()
                else:
                    engine._admit_pending()
                    torch.cuda.synchronize()
                wall = time.monotonic() - t0
                if engine.stats()["prefill_calls"] != calls + 1 or \
                        "sync" not in marks:
                    raise AssertionError(f"bucket {n}: the two prompts did "
                                         "not admit as one group")
                if mode == "timed":
                    rec["host_wall_ms"] = wall * 1e3
                    rec["entry_to_first_token_sync_ms"] = \
                        (marks["sync"] - marks["entry"]) * 1e3
                    # The host's part before the replay (pages, landing
                    # indices, the inputs' upload), the device idle.
                    rec["entry_to_replay_ms"] = \
                        (marks["replay"] - marks["entry"]) * 1e3
                elif mode == "profiled":
                    events = _device_events(prof)
                    rec["device_busy_ms"] = sum(
                        e.self_device_time_total for e in events) / 1e3
                    rec["kernels"] = sum(e.count for e in events)
                    rec["profiled_wall_ms"] = wall * 1e3
                while not all(f.done() for f in futs):
                    engine.step()
            rec["idle_share"] = 1 - rec["device_busy_ms"] / rec["host_wall_ms"]
            log(f"admission profile bucket {rec['bucket']} k=2: host wall "
                f"{rec['host_wall_ms']:.3f} ms, entry to first-token sync "
                f"{rec['entry_to_first_token_sync_ms']:.3f} ms (of it "
                f"{rec['entry_to_replay_ms']:.3f} ms before the replay), "
                f"device busy "
                f"{rec['device_busy_ms']:.3f} ms in {rec['kernels']} kernels "
                f"(idle share {rec['idle_share']:.3f})")
            out[str(rec["bucket"])] = rec
    finally:
        del engine._admit_batch, engine._first_tokens, engine._replay
    engine.drain(timeout=60)
    return out


def _slo_work(seed: int = 0) -> list:
    """``benchmarks/serving.py``'s SLO workload, drawn the same way:
    ``(arrival s, prompt, class)`` for two waves."""
    rng = np.random.default_rng(seed)
    V = FULL["vocab_size"]
    work, t = [], 0.0
    for _ in range(2):
        for _ in range(2):
            n = int(rng.integers(SLO_LONG - 48, SLO_LONG + 1))
            work.append((t, rng.integers(0, V, n).tolist(), "batch"))
        for j in range(6):
            n = int(rng.integers(3, 13))
            work.append((t + 0.01 * (j + 1),
                         rng.integers(0, V, n).tolist(), "interactive"))
        t += 0.25
    return work


def slo_leg(params, cfg, slo: bool, fault: bool = False) -> dict:
    """One leg of the SLO workload on a fresh warmed engine driven by its
    own thread, the arrivals on their schedule: ``slo`` chunked (32
    tokens) with the two classes, else whole-prompt prefill with one
    class.  With ``fault``, a ``prefill_chunk`` raise at a chunk
    boundary.  Every request must return its full count and the tick be
    captured once (with the fault: one restart, ``healthy`` at the
    end).  Per-class TTFT p50 / p99 as ``benchmarks/serving.py`` takes
    them."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import (EngineConfig, FaultInjector,
                                           FaultSpec, InferenceEngine)

    inj = FaultInjector()
    engine = InferenceEngine(params, cfg, EngineConfig(
        **SLO_ENGINE, prefill_chunk_tokens=SLO_CHUNK if slo else 0,
        faults=inj))
    work = _slo_work()
    t0 = time.monotonic()
    engine.warmup(_warm_lens(engine, {len(p) for _, p, _ in work}))
    warm_s = time.monotonic() - t0
    graphs = _admission_graphs(engine)
    if fault:
        inj.add(FaultSpec(site="prefill_chunk", kind="raise",
                          skip=inj.visits("prefill_chunk") + SLO_FAULT_SKIP))
    before = engine.stats()
    # This leg's run: the launch counters read 0 here and are read again
    # after its last request.
    A.flash_fwd_launches = 0
    PA.paged_attend_launches = 0
    engine.start()
    try:
        futs = []
        t0 = time.monotonic()
        for arrival, prompt, pri in work:
            now = time.monotonic() - t0
            if now < arrival:
                time.sleep(arrival - now)
            futs.append((pri, engine.submit(
                prompt, max_new_tokens=SLO_NEW_TOKENS,
                priority=pri if slo else "interactive")))
        for _, f in futs:
            f.result(timeout=600)
        wall = time.monotonic() - t0
    finally:
        engine.stop()
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches}
    st = engine.stats()
    label = ("slo" if slo else "fcfs") + (" f32 faulted" if fault else "")
    for i, (_, f) in enumerate(futs):
        got = f.result(timeout=0)
        if len(got) != SLO_NEW_TOKENS or f.finish_reason != "length":
            raise AssertionError(f"{label} request {i} returned {len(got)} "
                                 f"tokens ({f.finish_reason})")
    if st["decode_compilations"] != 1:
        raise AssertionError(f"{label}: decode_compilations "
                             f"{st['decode_compilations']}")
    if _admission_graphs(engine) != graphs:
        raise AssertionError(f"{label}: the leg captured past its warmup: "
                             f"{graphs} before, {_admission_graphs(engine)}")
    restarts = st["engine_restarts"] - before["engine_restarts"]
    if (restarts, st["state"]) != ((1 if fault else 0), "healthy"):
        raise AssertionError(f"{label}: {restarts} restarts, state "
                             f"{st['state']}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"{label}: the run missed a kernel: {launches}")
    out = {"leg": label, "requests": len(futs), "wall_s": wall,
           "tok_per_s": len(futs) * SLO_NEW_TOKENS / wall,
           "preemptions": st["preemptions"] - before["preemptions"],
           "engine_restarts": restarts, "fired": inj.fired,
           "decode_compilations": st["decode_compilations"],
           "warmup_s": warm_s, "admission_graphs": graphs,
           "launches": launches, "prompts": [p for _, p, _ in work],
           "tokens": [f.result(timeout=0) for _, f in futs]}
    for cls in ("interactive", "batch"):
        vals = sorted(f.ttft for pri, f in futs if pri == cls)
        out[f"{cls}_ttft_ms_p50"] = vals[len(vals) // 2] * 1e3
        out[f"{cls}_ttft_ms_p99"] = \
            vals[min(len(vals) - 1, int(len(vals) * 0.99))] * 1e3
    log(f"SLO leg {label}: {out['tok_per_s']:.1f} tok/s; TTFT p50/p99 "
        f"interactive {out['interactive_ttft_ms_p50']:.1f}/"
        f"{out['interactive_ttft_ms_p99']:.1f} ms, batch "
        f"{out['batch_ttft_ms_p50']:.1f}/{out['batch_ttft_ms_p99']:.1f} "
        f"ms; {out['preemptions']} preemptions, {restarts} restarts "
        f"(fired {inj.fired}); launches {launches}; warmup {warm_s:.3f} s, "
        f"admission graphs {graphs} before and after")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def prefix_identity_f32(engine, params, cfg) -> dict:
    """On the f32 engine: the registered prefix with three sharers (one
    sampled) and one request whose prompt is the prefix, against the
    whole prompt's oracle (the near-tie rule of ``_check_f32``); the pool
    whole again after ``unregister_prefix``."""
    prefix, prompts = _prefix_prompts(seed=6)
    pick = (0, 1, 5, 6)
    prompts = [prompts[i] for i in pick]
    sampling = [PREFIX_SAMPLING[i] for i in pick]
    engine.register_prefix(prefix)
    futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS, **sampling[i])
            for i, p in enumerate(prompts)]
    while not all(f.done() for f in futs):
        engine.step()
    engine.unregister_prefix(prefix)
    engine.drain(timeout=60)
    refs = _f32_oracles(params, cfg, prompts, sampling, F32_NEW_TOKENS)
    exempt = _check_f32("f32 prefix", prompts,
                        [f.result(timeout=0) for f in futs], refs, sampling)
    if engine.slots.free_pages != engine.slots.n_pages:
        raise AssertionError("f32 prefix: pages left after unregister")
    log(f"prefix identity f32: {len(prompts)} requests over a "
        f"{PREFIX_LEN}-token prefix ({[len(p) for p in prompts]} tokens), "
        f"{len(exempt)} near-tie exemptions")
    return {"prompt_lens": [len(p) for p in prompts], "exemptions": exempt}


def slo_identity_f32(params, cfg) -> dict:
    """The SLO leg in f32, chunked with priorities, through one
    ``prefill_chunk`` fault: every request's tokens against
    ``greedy_decode`` of its prompt (the near-tie rule)."""
    leg = slo_leg(params, cfg, slo=True, fault=True)
    prompts, greedy = leg.pop("prompts"), [{}] * leg["requests"]
    refs = _f32_oracles(params, cfg, prompts, greedy, SLO_NEW_TOKENS)
    leg["exemptions"] = _check_f32("f32 SLO", prompts, leg.pop("tokens"),
                                   refs, greedy)
    log(f"SLO identity f32: {len(prompts)} requests through fault "
        f"{leg['fired']}, {len(leg['exemptions'])} near-tie exemptions")
    return leg


# --- phases 6 and 7: training --------------------------------------------------


# --- speculative decoding ----------------------------------------------------


def _draft_model(name: str, params, cfg):
    """``(draft_params, draft_cfg)`` of a draft source: None for the
    n-gram draft, the target itself, or a half-depth model made of the
    target's first layers, its embedding, final norm and head."""
    import dataclasses

    if name == "ngram":
        return None, None
    if name == "self":
        return params, cfg
    n = cfg.n_layers // 2
    dcfg = dataclasses.replace(cfg, n_layers=n)
    return ({**params, "layers": {k: v[:n].contiguous()
                                  for k, v in params["layers"].items()}},
            dcfg)


def _spec_engine(name: str, params, cfg, **kw):
    from horovod_tpu_torch.serving import EngineConfig, InferenceEngine

    dp, dc = _draft_model(name, params, cfg)
    return InferenceEngine(
        params, cfg, EngineConfig(**ENGINE, speculative=True, spec_k=SPEC_K,
                                  **kw), draft_params=dp, draft_cfg=dc)


def spec_identity_f32(params, cfg, prompts, refs, plain_outs) -> dict:
    """The f32 burst through a speculative engine of each draft source:
    its tokens against the oracles and against the plain engine's
    (``plain_outs``), by the near-tie rule; the self-draft's acceptance
    at least 0.9 and more than one token a tick; then the same burst on
    the same engine through one decode fault once ``SPEC_FAULT_AT``
    tokens are out: the oracles' tokens again, one restart, two
    captures."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import FaultInjector

    out = {}
    for name in SPEC_DRAFTS:
        inj = FaultInjector()
        engine = _spec_engine(name, params, cfg, faults=inj)
        engine.warmup((8,))
        futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS,
                              **SAMPLING[i]) for i, p in enumerate(prompts)]
        while not all(f.done() for f in futs):
            engine.step()
        outs = [f.result(timeout=0) for f in futs]
        exempt = _check_f32(f"f32 spec {name}", prompts, outs, refs)
        vs_plain = _check_f32(f"f32 spec {name} vs plain", prompts, outs,
                              [(o, r[1]) for o, r in zip(plain_outs, refs)])
        st = engine.stats()
        acc, tpt = st["spec_acceptance_ratio"], st["tokens_per_tick"]["mean"]
        if name == "self" and not (acc is not None and acc >= 0.9
                                   and tpt > 1):
            raise AssertionError(f"f32 self-draft: acceptance {acc}, "
                                 f"{tpt} tokens a tick")
        A.flash_fwd_launches = 0
        PA.paged_attend_launches = 0
        futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS,
                              **SAMPLING[i]) for i, p in enumerate(prompts)]
        run = _burst_with_faults(engine, inj, futs,
                                 [("decode_tick", "raise", SPEC_FAULT_AT)])
        launches = {"flash_fwd": A.flash_fwd_launches,
                    "paged_attend": PA.paged_attend_launches}
        fault_exempt = _check_f32(f"f32 spec {name} faulted", prompts,
                                  [f.result(timeout=0) for f in futs], refs)
        st = _durability_checks(f"f32 spec {name} faulted", engine,
                                launches, 1, captures=2)
        out[name] = {"exemptions": exempt, "exemptions_vs_plain": vs_plain,
                     "acceptance": acc, "tokens_per_tick_mean": tpt,
                     "faulted_exemptions": fault_exempt,
                     "recovery_s": run["recovery_s"],
                     "requests_resumed": st["requests_resumed"],
                     "launches": launches}
        log(f"speculative f32 {name}: {len(prompts)} requests (half "
            f"sampled) equal the oracles and the plain engine ({len(exempt)}"
            f" / {len(vs_plain)} near-tie exemptions); acceptance {acc}, "
            f"{tpt:.3f} tokens a tick; through a decode fault "
            f"{len(fault_exempt)} exemptions, {st['requests_resumed']} "
            f"resumes, decode_compilations 2")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _measure_spec(engines: dict, prompts, steps: int, reps: int) -> dict:
    """``_ab_spec``'s measurement: each engine decodes the same prompts,
    interleaved repetitions (the first warm, unmeasured), and tok/s over
    the steps at full occupancy (tokens and wall summed a step, as a
    speculative step emits a varying count).  Returns each engine's
    tok/s, its tokens (every repetition) and its full-occupancy steps."""
    stats = {n: [0, 0.0, [], 0] for n in engines}
    for rep in range(reps + 1):
        for name, eng in engines.items():
            futs = [eng.submit(p, max_new_tokens=steps) for p in prompts]
            while not all(f.done() for f in futs):
                full = eng.slots.active_count == ENGINE["n_slots"]
                before = eng.metrics.tokens_generated.value
                t0 = time.perf_counter()
                eng.step()
                dt = time.perf_counter() - t0
                if full and rep:
                    stats[name][0] += (eng.metrics.tokens_generated.value
                                       - before)
                    stats[name][1] += dt
                    stats[name][3] += 1
            stats[name][2].append([f.result(timeout=0) for f in futs])
    return {n: {"tok_per_s": v[0] / v[1] if v[1] else 0.0,
                "tokens": v[2], "steps": v[3]}
            for n, v in stats.items()}


def _profile_steps(engine, prompts, n_steps: int = 8) -> dict:
    """Host wall a step at full occupancy over ``n_steps`` steps, then
    device busy a step by ``torch.profiler`` over ``n_steps`` more (the
    profiler's host cost stays out of the wall), and which graph the
    profiled steps ran (the speculative tick or the plain one)."""
    from torch.profiler import ProfilerActivity, profile

    futs = [engine.submit(p, max_new_tokens=SPEC_NEW_TOKENS)
            for p in prompts]
    while engine.scheduler.depth or engine._taken:
        engine.step()
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) * 1e3 / n_steps
    spec0, plain0 = engine._spec_tick.runs, engine._tick.runs
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in _device_events(prof)) \
        / 1e3 / n_steps
    out = {"steps": n_steps, "step_wall_ms": wall, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall,
           "spec_replays": engine._spec_tick.runs - spec0,
           "plain_replays": engine._tick.runs - plain0}
    while not all(f.done() for f in futs):
        engine.step()
    return out


def spec_leg_bf16(name: str, params, cfg, plain, prompts, card) -> dict:
    """One draft source's bf16 leg against the plain engine ``plain``:
    the measured repetitions (the main path's run: the launch counters
    read 0 before and are read after), acceptance, tokens a tick, each
    graph's replays, the step's profile, then the HTTP burst."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA
    from horovod_tpu_torch.serving import ServingServer

    engine = _spec_engine(name, params, cfg)
    t0 = time.monotonic()
    engine.warmup([SPEC_PROMPT_LEN])
    warm_s = time.monotonic() - t0
    graphs0 = _admission_graphs(engine)
    if graphs0["decode_compilations"] != 2:
        raise AssertionError(f"spec {name}: decode_compilations "
                             f"{graphs0['decode_compilations']} after warmup")
    spec0, plain0 = engine._spec_tick.runs, engine._tick.runs
    A.flash_fwd_launches = 0
    PA.paged_attend_launches = 0
    PA.paged_attend_launches_by_rows.clear()
    m = _measure_spec({"spec": engine, "plain": plain}, prompts,
                      SPEC_NEW_TOKENS, SPEC_REPS)
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches,
                "paged_attend_by_rows": dict(PA.paged_attend_launches_by_rows)}
    spec_replays = engine._spec_tick.runs - spec0
    plain_replays = engine._tick.runs - plain0
    st = engine.stats()
    verify_rows = FULL["n_heads"] // FULL["n_kv_heads"] * (SPEC_K + 1)
    if not (launches["flash_fwd"] > 0 and launches["paged_attend"] > 0
            and launches["paged_attend_by_rows"].get(verify_rows, 0) > 0):
        raise AssertionError(f"spec {name}: the leg missed a kernel: "
                             f"{launches}")
    if name == "ngram" and plain_replays == 0:
        raise AssertionError("spec ngram: the adaptive control never fell "
                             "back to the plain graph")
    ratio = m["spec"]["tok_per_s"] / m["plain"]["tok_per_s"]
    prof = _profile_steps(engine, prompts)
    # The HTTP burst: half sampled, one request opted out.
    srv = ServingServer(engine, port=0, request_timeout=600).start()
    url = "http://%s:%d/generate" % srv.address
    results = [None] * len(prompts)

    def client(i):
        results[i] = _post(url, {"tokens": prompts[i],
                                 "max_new_tokens": SPEC_NEW_TOKENS // 2,
                                 "speculative": i != 2, **SAMPLING[i]})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    srv.stop()
    for i, res in enumerate(results):
        if res is None or res[0] != 200 or \
                len(res[1]["tokens"]) != SPEC_NEW_TOKENS // 2:
            raise AssertionError(f"spec {name}: HTTP request {i} failed: "
                                 f"{res and res[0]}")
    graphs1 = _admission_graphs(engine)
    if graphs1 != graphs0:
        raise AssertionError(f"spec {name}: captured past the warmup: "
                             f"{graphs0} before, {graphs1} after")
    out = {"draft": name, "warmup_s": warm_s,
           "spec_tok_per_s": m["spec"]["tok_per_s"],
           "plain_tok_per_s": m["plain"]["tok_per_s"],
           "spec_over_plain": ratio,
           "full_steps": {n: v["steps"] for n, v in m.items()},
           "equal_tokens_to_plain": m["spec"]["tokens"] == m["plain"]["tokens"],
           "acceptance": st["spec_acceptance_ratio"],
           "tokens_per_tick_mean": st["tokens_per_tick"]["mean"],
           "spec_slots_live": st["spec_slots_live"],
           "spec_replays": spec_replays, "plain_replays": plain_replays,
           "launches": launches, "profile": prof,
           "decode_compilations": graphs1["decode_compilations"],
           "admission_graphs": graphs1}
    log(f"speculative bf16 {name} on {card}: {out['spec_tok_per_s']:.1f} "
        f"tok/s against plain {out['plain_tok_per_s']:.1f} "
        f"({ratio:.3f}x, full-occupancy steps); acceptance "
        f"{out['acceptance']}, {out['tokens_per_tick_mean']:.3f} tokens a "
        f"tick; replays spec {spec_replays} plain {plain_replays}; step "
        f"{prof['step_wall_ms']:.3f} ms wall, {prof['device_busy_ms']:.3f} "
        f"ms device (idle {prof['idle_share']:.3f}; {prof['spec_replays']} "
        f"spec / {prof['plain_replays']} plain replays); tokens equal to "
        f"plain: {out['equal_tokens_to_plain']}; launches {launches}; "
        "HTTP burst full, decode_compilations 2, no capture past warmup")
    engine.terminate("speculative leg done")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spec_full_width(card: str) -> dict:
    """The bf16 legs of every draft source (``SPEC_DRAFTS``) against one
    plain engine, on the serving phase's configuration."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = T.TransformerConfig(**FULL, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, FULL["vocab_size"], SPEC_PROMPT_LEN).tolist()
               for _ in range(ENGINE["n_slots"])]
    plain = InferenceEngine(params, cfg, EngineConfig(**ENGINE))
    plain.warmup([SPEC_PROMPT_LEN])
    out = {"prompt_len": SPEC_PROMPT_LEN, "new_tokens": SPEC_NEW_TOKENS,
           "reps": SPEC_REPS, "spec_k": SPEC_K, "legs": {}}
    for name in SPEC_DRAFTS:
        out["legs"][name] = spec_leg_bf16(name, params, cfg, plain, prompts,
                                          card)
    del plain, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def model_grads_f32() -> dict:
    """f32 loss and every parameter gradient of a 2-layer model, TF32 off:
    attention by K1-K3 against the plain softmax attention (tolerance
    1e-4 of each parameter's largest gradient: f32 summation order), and
    remat ``full`` and ``dots`` against no remat, both through K1-K3
    (tolerance 1e-5: the recompute runs the same kernels on the same
    inputs)."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.optim import named_parameters

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = dict(FULL, n_layers=2, max_seq=512)
    grads = {}
    for name, impl, remat in (("flash", "flash", None),
                              ("reference", "reference", None),
                              ("remat_full", "flash", "full"),
                              ("remat_dots", "flash", "dots")):
        cfg = T.TransformerConfig(**dict(small, attention_impl=impl),
                                  dtype=torch.float32,
                                  remat=remat is not None,
                                  remat_policy=remat or "full")
        params = T.init_params(cfg, seed=1, param_dtype=torch.float32)
        named = named_parameters(params)
        for _, t in named:
            t.requires_grad_()
        batch = T.synthetic_batch(1, cfg, 2, 512)
        loss = T.loss_fn(params, batch, cfg)
        loss.backward()
        grads[name] = (loss.item(), {n: t.grad for n, t in named})
    lf, gf = grads["flash"]
    out = {"loss_flash": lf}
    for other, tol in (("reference", 1e-4), ("remat_full", 1e-5),
                       ("remat_dots", 1e-5)):
        lo, go = grads[other]
        errs = {n: ((go[n] - gf[n]).abs().max() / gf[n].abs().max()).item()
                for n in gf}
        worst = max(errs, key=errs.get)
        log(f"model f32 (L=2, d1024, H16, kv4, seq 512, batch 2): loss "
            f"flash {lf:.7f} {other} {lo:.7f}; worst gradient {worst} "
            f"rel_err {errs[worst]:.3e} tol {tol:.0e}")
        if not (abs(lo - lf) <= 1e-5 * abs(lf) and errs[worst] <= tol):
            raise AssertionError(f"the {other} model gradients disagree "
                                 "with the flash path's")
        out[f"loss_{other}"] = lo
        out[f"grad_rel_err_{other}"] = errs
    del grads, gf
    torch.cuda.empty_cache()
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def profile_train_step(step, params, batch, flash: bool = True) -> dict:
    """One more step under ``torch.profiler``: device time by kernel,
    against that step's own wall time (the profiler slows the host).
    ``flash``: the step runs K1-K3 (the LM's), whose share is reported
    and whose bf16 K3 must be the tensor-core kernel."""
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
           "top_kernels_ms": {k[:70]: t for k, t in sorted(
               kernels.items(), key=lambda kv: -kv[1])[:10]}}
    if not flash:
        log(f"step profile: device busy {busy:.1f} ms of {wall_ms:.1f} ms "
            f"(idle share {out['idle_share']:.3f})")
        return out
    out.update({"flash_fwd_ms": ms("flash_fwd_kernel"),
                "flash_bwd_dkdv_ms": ms("flash_bwd_dkdv_kernel"),
                "flash_bwd_dq_ms": ms("flash_bwd_dq_kernel")})
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


TRAIN_LEGS = ("eager", "remat_full", "remat_dots", "captured")


def _train_leg(name: str) -> dict:
    """One training leg at full width: 10 steps from ``init_params`` seed
    0 on one fixed batch.  ``eager`` and the remat legs call the step's
    eager body (``TrainStep.body``); ``captured`` calls the step itself,
    which warms up eagerly, captures one CUDA graph and replays it.
    The K1-K3 counters read 0 just before the steps and are read just
    after them."""
    from horovod_tpu_torch import optim, spmd
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A

    remat = name.startswith("remat")
    cfg = T.TransformerConfig(**TRAIN, dtype=torch.bfloat16, remat=remat,
                              remat_policy=name[6:] if remat else "full")
    params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
    named = optim.named_parameters(params)
    for _, t in named:
        t.requires_grad_()
    n_params = sum(t.numel() for _, t in named)
    n_matmul = n_params - params["embed"].numel()
    opt = optim.DistributedOptimizer(
        torch.optim.AdamW([t for _, t in named], lr=3e-4,
                          betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
        named_parameters=named)
    step = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)
    if not step.graphed:
        raise AssertionError("make_train_step did not capture on CUDA")
    run = step if name == "captured" else step.body
    B, S = TRAIN_BATCH, TRAIN["max_seq"]
    batch = T.synthetic_batch(0, cfg, B, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.flash_fwd_launches = 0
    A.flash_bwd_dkdv_launches = 0
    A.flash_bwd_dq_launches = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.monotonic()
        losses.append(float(run(params, batch)))  # waits for the card
        times.append(time.monotonic() - t0)
    launches = {"flash_fwd": A.flash_fwd_launches,
                "flash_bwd_dkdv": A.flash_bwd_dkdv_launches,
                "flash_bwd_dq": A.flash_bwd_dq_launches}
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times)
    # Useful work only: a remat leg's recompute is not counted.
    flops = 6 * n_matmul * B * S + 6 * cfg.n_layers * B * S * S * \
        cfg.d_model
    out = {"params": n_params, "matmul_params": n_matmul,
           "losses": losses, "step_s": times, "step_s_median": step_s,
           "tokens_per_s": B * S / step_s, "step_flops": flops,
           "mfu": flops / step_s / PEAK_FLOPS[torch.bfloat16],
           "bound_step_ms": flops / PEAK_FLOPS[torch.bfloat16] * 1e3,
           "peak_mem_gb": peak / 1e9, "launches": launches,
           "captures": step.captures, "replays": step.replays}
    log(f"train [{name}] losses: {[round(x, 4) for x in losses]}")
    log(f"train [{name}]: {n_params} params, median step "
        f"{step_s * 1e3:.1f} ms, {out['tokens_per_s']:.0f} tok/s, MFU "
        f"{out['mfu']:.4f} (useful FLOP only; bound "
        f"{out['bound_step_ms']:.1f} ms a step), peak memory "
        f"{out['peak_mem_gb']:.2f} GB, launches {launches}, captures "
        f"{step.captures}, replays {step.replays}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    L = cfg.n_layers * TRAIN_STEPS
    want = {"flash_fwd": 2 * L if remat else L, "flash_bwd_dkdv": L,
            "flash_bwd_dq": L}
    if launches != want:
        raise AssertionError(f"[{name}] expected K1-K3 launches {want}, got "
                             f"{launches}")
    if name == "captured" and (step.captures != 1 or step.replays
                               != TRAIN_STEPS - spmd.WARMUP_STEPS):
        raise AssertionError(f"captured leg: {step.captures} captures, "
                             f"{step.replays} replays")
    out["profile"] = profile_train_step(run, params, batch)
    del params, opt, step, run, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_full_width() -> dict:
    """The main training path, through the entry points a user calls, in
    four legs (``TRAIN_LEGS``) on a size-1 NCCL group: each remat leg's
    and the captured leg's losses equal the eager leg's within 1e-3
    relative a step, and each remat leg's peak memory is below the eager
    leg's."""
    from horovod_tpu_torch import basics

    # The serving engines hold themselves in reference cycles (the
    # scheduler's callbacks): collect them, so that the peak memory
    # below is the training run's own.
    gc.collect()
    torch.cuda.empty_cache()
    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        legs = {name: _train_leg(name) for name in TRAIN_LEGS}
    finally:
        basics.shutdown()
    eager = legs["eager"]
    for name in TRAIN_LEGS[1:]:
        gap = max(abs(a - b) / abs(b) for a, b in
                  zip(legs[name]["losses"], eager["losses"]))
        legs[name]["loss_gap_vs_eager"] = gap
        log(f"train [{name}] largest loss gap against eager: {gap:.3e} "
            "(limit 1e-3 relative)")
        if gap > 1e-3:
            raise AssertionError(f"[{name}] losses differ from eager's by "
                                 f"{gap:.3e}")
        if name.startswith("remat") and not (
                legs[name]["peak_mem_gb"] < eager["peak_mem_gb"]):
            raise AssertionError(f"[{name}] peak memory "
                                 f"{legs[name]['peak_mem_gb']:.2f} GB is not "
                                 f"below eager's {eager['peak_mem_gb']:.2f}")
    launches = {k: sum(leg["launches"][k] for leg in legs.values())
                for k in eager["launches"]}
    return {"legs": legs, "launches": launches}


# --- the tracing phase: spans, timeline, profile and /metrics ---------------

TRACE_LEGS = ("untraced", "traced", "traced", "untraced") * 2
TRACE_PROFILE_TICKS = 20
TRACE_TRAIN_STEPS = 5
# Tail sampling of the traced legs: no latency verdict, so that only the
# forced request (and any that errs or carries a typed event) keeps its
# per-tick detail.
TRACE_SAMPLING = dict(latency_threshold_s=30.0, max_tick_spans=512)
# The trace headers of the burst: request 0 names its trace and its
# parent span, request 1 its trace and forces full span detail.
TRACE_HEADERS = {0: {"X-Trace-Id": "smoke-parented",
                     "X-Parent-Span": "feedfacecafebeef"},
                 1: {"X-Trace-Id": "smoke-sampled", "X-Trace-Sampled": "1"}}


def _prom_parse(text: str) -> dict:
    """A strict reading of Prometheus text (0.0.4): every line a ``# HELP
    name text``, a ``# TYPE name kind`` or a sample ``name{labels}
    value``; every sample's family announced by HELP and TYPE before it
    (a histogram's ``_bucket``/``_sum``/``_count`` samples belong to it).
    Returns ``{family: {"type", "help", "samples": [(name, labels,
    value)]}}``."""
    name = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
    sample = re.compile(rf"^({name})(?:\{{((?:[a-zA-Z_][a-zA-Z0-9_]*="
                        r'"(?:[^"\\]|\\.)*",?)*)\})? '
                        r"(-?[0-9.]+(?:[eE][+-]?[0-9]+)?|[+-]?Inf|NaN)$")
    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    fams: dict = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            fam = line[7:].split(" ", 1)[0]
            fams.setdefault(fam, {"type": None, "help": None,
                                  "samples": []})["help"] = line
            continue
        if line.startswith("# TYPE "):
            fam, kind = line[7:].split(" ")
            if fam not in fams or kind not in ("counter", "gauge",
                                               "histogram"):
                raise AssertionError(f"/metrics: TYPE before HELP or an "
                                     f"unknown type: {line!r}")
            fams[fam]["type"] = kind
            continue
        m = sample.match(line)
        if not m:
            raise AssertionError(f"/metrics: not a sample line: {line!r}")
        sname = m.group(1)
        fam = sname
        if fam not in fams:
            for suffix in ("_bucket", "_sum", "_count"):
                if sname.endswith(suffix) and \
                        sname[:-len(suffix)] in fams:
                    fam = sname[:-len(suffix)]
        if fam not in fams or fams[fam]["type"] is None:
            raise AssertionError(f"/metrics: sample before its family's "
                                 f"HELP and TYPE: {line!r}")
        fams[fam]["samples"].append(
            (sname, dict(label.findall(m.group(2) or "")),
             float(m.group(3))))
    bare = sorted(f for f, v in fams.items() if v["type"] is None)
    if bare:
        raise AssertionError(f"/metrics: families without a TYPE: {bare}")
    return fams


def _lines(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _http_burst(engine, base: str, prompts, timed: list) -> dict:
    """The eight greedy requests through the server, queued in a fixed
    order with the engine held (its lock), then released at once: every
    leg schedules the same way, so its tokens, ticks and host syncs are
    the same.  Returns the replies, the wall and the counters' moves."""
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import paged_attention as PA

    results = [None] * len(prompts)

    def quiesce():
        # The pipeline's last tick is fetched by the step after its
        # requests resolve (``_pending`` is cleared before that fetch,
        # inside the step): read between steps, under the engine's lock,
        # so that the fetch counts inside the leg, never across legs.
        deadline = time.monotonic() + 60
        while True:
            with engine._lock:
                if engine._pending is None and not engine.slots.active_count:
                    return
            if time.monotonic() > deadline:
                raise AssertionError("the engine did not go idle")
            time.sleep(0.001)

    def client(i):
        req = urllib.request.Request(
            base + "/generate", data=json.dumps({
                "tokens": prompts[i],
                "max_new_tokens": NEW_TOKENS[i]}).encode(),
            headers={"Content-Type": "application/json",
                     **TRACE_HEADERS.get(i, {})}, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            results[i] = (r.status, json.loads(r.read()))

    m = engine.metrics
    # (generation, seconds) of each garbage collection during the leg
    pauses, started = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            pauses.append((info["generation"],
                           time.perf_counter() - started[0]))

    quiesce()
    graphs0 = _admission_graphs(engine)
    syncs0, ticks0 = m.host_syncs.value, m.decode_ticks.value
    threads = []
    with engine._lock:
        for i in range(len(prompts)):
            depth = engine.scheduler.depth
            t = threading.Thread(target=client, args=(i,))
            t.start()
            threads.append(t)
            deadline = time.monotonic() + 30
            while engine.scheduler.depth == depth:
                if time.monotonic() > deadline:
                    raise AssertionError(f"request {i} was not queued")
                time.sleep(0.001)
        del timed[:]
        A.flash_fwd_launches = 0
        PA.paged_attend_launches = 0
        gc.callbacks.append(on_gc)
        t0 = time.monotonic()
    try:
        for t in threads:
            t.join(600)
        wall = time.monotonic() - t0
    finally:
        gc.callbacks.remove(on_gc)
    gcs = [sum(1 for g, _ in pauses if g == n) for n in range(3)]
    quiesce()
    launches = {"flash_fwd": A.flash_fwd_launches,
                "paged_attend": PA.paged_attend_launches}
    for i, res in enumerate(results):
        if res is None or res[0] != 200 or \
                len(res[1]["tokens"]) != NEW_TOKENS[i]:
            raise AssertionError(f"traced burst: request {i} returned {res}")
    ticks = m.decode_ticks.value - ticks0
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    return {"replies": [r[1] for r in results], "wall_s": wall,
            "tok_per_s": sum(NEW_TOKENS) / wall,
            "tick_wall_ms_median": statistics.median(timed) * 1e3,
            # Steady decode rate at full occupancy: a tick emits a token
            # for every slot.
            "decode_tok_per_s": ENGINE["n_slots"] / statistics.median(timed),
            "tick_wall_ms_max": max(timed) * 1e3,
            "tick_wall_ms_sum": sum(timed) * 1e3,
            "ttft_ms_p50": statistics.median(ttft), "ttft_ms_max": ttft[-1],
            "gc_collections": gcs,
            "gc_ms_total": sum(d for _, d in pauses) * 1e3,
            "gc_ms_max": max((d for _, d in pauses), default=0.0) * 1e3,
            "decode_steps": len(timed), "decode_ticks": ticks,
            "host_syncs_per_tick": (m.host_syncs.value - syncs0) / ticks,
            "launches": launches, "graphs": (graphs0,
                                             _admission_graphs(engine))}


def _check_spans(leg: dict, span_path, replies) -> dict:
    """One traced leg's span stream: every request one start and one
    finish record; request 0's span under the given parent, request 1's
    detail kept (one tick span a decode tick), the clean requests'
    dropped; each breakdown's phases summing to its total."""
    from horovod_tpu_torch.obs.trace_store import TraceStore

    recs = _lines(span_path)
    store = TraceStore([str(span_path)])
    out = {"span_lines_per_request": (len(recs) - 1) / len(replies)}
    for i, body in enumerate(replies):
        b = body["breakdown"]
        sid, tid = b["span_id"], body["trace_id"]
        mine = [r for r in recs if sid in (r.get("id"), r.get("span"),
                                           r.get("parent"))]
        kinds = [r["k"] for r in mine]
        if kinds.count("s") != 1 or kinds.count("f") != 1:
            raise AssertionError(f"request {i}: span records {kinds}")
        roots = store.tree(tid)
        if [n.id for n in roots] != [sid]:
            raise AssertionError(f"request {i}: trace tree roots "
                                 f"{[n.id for n in roots]}, want [{sid}]")
        parts = b["queue_wait_s"] + b["prefill_s"] + b["decode_s"]
        if abs(parts - b["total_s"]) > 1e-3:
            raise AssertionError(f"request {i}: breakdown {b} does not sum")
        fin = [r for r in mine if r["k"] == "f"][0]["a"]
        ticks = sum(1 for r in mine if r["k"] == "d" and r["name"] == "tick")
        if i == 0 and roots[0].parent != TRACE_HEADERS[0]["X-Parent-Span"]:
            raise AssertionError(f"request 0's span has parent "
                                 f"{roots[0].parent}")
        if i == 1 and (fin.get("retained") != "forced"
                       or ticks != min(b["decode_ticks"],
                                       TRACE_SAMPLING["max_tick_spans"])
                       or ticks == 0):
            raise AssertionError(f"request 1: retained "
                                 f"{fin.get('retained')}, {ticks} tick "
                                 f"spans for {b['decode_ticks']} ticks")
        if i >= 2 and (fin.get("retained") is not None or ticks):
            raise AssertionError(f"request {i} kept detail: "
                                 f"{fin.get('retained')}, {ticks} ticks")
    return out


def _traced_fault(engine, prompts, span_dir, journal) -> dict:
    """The burst stepped synchronously with the tracer and spans on, one
    decode tick raising once every request has a token: each request
    the restart interrupts gets ``engine_restart`` then ``resume`` on its
    own span, and its live journal entry (``read_live``) names that
    span."""
    from horovod_tpu_torch.obs import tracing as TR
    from horovod_tpu_torch.serving import FaultSpec, RequestJournal

    rec = TR.start_spans(str(span_dir / "fault.jsonl"), proc="engine",
                         sampling=TR.SpanSampling(**TRACE_SAMPLING))
    try:
        futs = [engine.submit(p, max_new_tokens=n, trace_id=f"fault-{i}")
                for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS))]
        while not all(f.tokens_so_far() for f in futs):
            engine.step()
        live = RequestJournal.read_live(journal)
        want = {f.trace_id: f.trace.span_id for f in futs if not f.done()}
        got = {k: v["span_id"] for k, v in live.items()}
        if got != want:
            raise AssertionError(f"journal span ids {got}, want {want}")
        inj = engine.engine_cfg.faults
        restarts = engine.metrics.engine_restarts.value
        inj.add(FaultSpec(site="decode_tick", kind="raise",
                          skip=inj.visits("decode_tick")))
        interrupted = [f for f in futs if not f.done()]
        while not all(f.done() for f in futs):
            engine.step()
        torch.cuda.synchronize()
    finally:
        TR.stop_spans()
    if engine.metrics.engine_restarts.value != restarts + 1:
        raise AssertionError("the traced fault did not restart the engine")
    for i, f in enumerate(futs):
        if len(f.result(timeout=0)) != NEW_TOKENS[i]:
            raise AssertionError(f"traced fault: request {i} short")
    recs = _lines(rec.path)
    for f in interrupted:
        ev = [r["type"] for r in recs
              if r["k"] == "e" and r.get("span") == f.trace.span_id]
        if ev != ["engine_restart", "resume"]:
            raise AssertionError(f"{f.trace_id}: span events {ev}")
        if [k for k, _, _ in f.trace.events] != ev:
            raise AssertionError(f"{f.trace_id}: trace events "
                                 f"{f.trace.events}")
    return {"interrupted": len(interrupted),
            "journal_span_ids": len(got)}


def _profile_ticks(engine, tl, prof_dir) -> dict:
    """``Timeline.profile`` over ``TRACE_PROFILE_TICKS`` steady captured
    ticks at 8 slots: the exported Chrome trace must name K4's split and
    combine kernels, a launch each a layer a tick (the tick in flight
    when the window opens may add its own)."""
    futs = _fill_slots(engine, PROFILE_DEPTH, 3 * TRACE_PROFILE_TICKS + 8,
                       seed=7)
    replays = engine._tick.replays
    with tl.profile(str(prof_dir)):
        for _ in range(TRACE_PROFILE_TICKS):
            engine.step()
    if engine._tick.replays - replays != TRACE_PROFILE_TICKS:
        raise AssertionError("the profiled steps were not captured ticks")
    while not all(f.done() for f in futs):
        engine.step()
    with open(tl.profile_path) as f:
        events = json.load(f)["traceEvents"]
    n = FULL["n_layers"] * TRACE_PROFILE_TICKS
    counts = {}
    for k in ("paged_attend_split_kernel", "paged_attend_combine_kernel"):
        counts[k] = sum(1 for e in events if k in str(e.get("name", ""))
                        and e.get("ph") == "X")
        if not n <= counts[k] <= n + FULL["n_layers"]:
            raise AssertionError(f"profile of {TRACE_PROFILE_TICKS} ticks "
                                 f"holds {counts[k]} {k}, want {n}")
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if not kernels:
        raise AssertionError("the profile recorded no device kernel")
    return {"profile_path": tl.profile_path, "k4_kernels": counts,
            "device_kernels": kernels,
            "profile_bytes": Path(tl.profile_path).stat().st_size}


def _traced_train(tl_path) -> dict:
    """The captured LM step (``TRACE_TRAIN_STEPS`` steps: the eager
    warm-up, the capture, replays) inside ``obs.training_step`` with a
    timeline started: one ``train_step`` B/E pair a step on it,
    ``training_steps_total`` up by the step count, K1-K3 launched."""
    from horovod_tpu_torch import basics, obs, optim, spmd
    from horovod_tpu_torch import timeline as TL
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A

    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        cfg = T.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
        params = T.init_params(cfg, seed=0, param_dtype=torch.float32)
        named = optim.named_parameters(params)
        for _, t in named:
            t.requires_grad_()
        opt = optim.DistributedOptimizer(
            torch.optim.AdamW([t for _, t in named], lr=3e-4,
                              weight_decay=1e-4), named_parameters=named)
        step = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)
        batch = T.synthetic_batch(0, cfg, TRAIN_BATCH, TRAIN["max_seq"])
        steps = obs.training_metrics().steps
        n0 = steps.value
        A.flash_fwd_launches = 0
        A.flash_bwd_dkdv_launches = 0
        A.flash_bwd_dq_launches = 0
        TL.start_timeline(str(tl_path))
        losses = []
        try:
            for _ in range(TRACE_TRAIN_STEPS):
                with obs.training_step():
                    losses.append(float(step(params, batch)))
        finally:
            TL.stop_timeline()
        launches = {"flash_fwd": A.flash_fwd_launches,
                    "flash_bwd_dkdv": A.flash_bwd_dkdv_launches,
                    "flash_bwd_dq": A.flash_bwd_dq_launches}
        captures, replays = step.captures, step.replays
        del params, opt, step, batch
    finally:
        basics.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    with open(tl_path) as f:
        pairs = [e["ph"] for e in json.load(f) if e["name"] == "train_step"]
    if pairs != ["B", "E"] * TRACE_TRAIN_STEPS:
        raise AssertionError(f"train_step span events {pairs}")
    if steps.value - n0 != TRACE_TRAIN_STEPS:
        raise AssertionError("training_steps_total did not rise by the "
                             "step count")
    if captures != 1 or not all(math.isfinite(x) for x in losses) or \
            not all(n > 0 for n in launches.values()):
        raise AssertionError(f"traced training: captures {captures}, "
                             f"losses {losses}, launches {launches}")
    return {"steps": TRACE_TRAIN_STEPS, "train_step_pairs": len(pairs) // 2,
            "losses": losses, "captures": captures, "replays": replays,
            "launches": launches}


def tracing_full_width(card: str, tmp: Path) -> dict:
    """The serving phase's configuration (bf16, 8 slots, max_len 2176)
    traced: a fault with spans on, ``Timeline.profile`` over captured
    ticks and its merge with the host timeline, then four HTTP bursts of
    the eight greedy prompts on one engine, untraced and traced in turns
    (tokens, host syncs a tick and captures equal; K1 and K4 launched in
    each), the spans of the traced ones, a strict ``/metrics`` scrape,
    and the captured LM step inside ``obs.training_step``."""
    from horovod_tpu_torch import timeline as TL
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.obs import merge as M
    from horovod_tpu_torch.obs import tracing as TR
    from horovod_tpu_torch.obs import xprof
    from horovod_tpu_torch.obs.registry import training_metrics
    from horovod_tpu_torch.serving import (EngineConfig, FaultInjector,
                                           InferenceEngine, ServingServer)

    cfg = T.TransformerConfig(**FULL, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0)
    fpt = xprof.transformer_flops_per_token(params)
    compiles = training_metrics().compiles.labels(fn="serving_decode")
    decode0 = compiles.value
    journal = tmp / "journal.jsonl"
    engine = InferenceEngine(params, cfg, EngineConfig(
        **ENGINE, model_flops_per_token=fpt, faults=FaultInjector(),
        journal_path=str(journal)))
    engine.warmup(ENGINE_WARM_LENS)
    prompts = _prompts()
    out = {"model_flops_per_token": fpt}
    # A fault with spans on, and the profile, stepped synchronously.
    span_dir = tmp / "spans"
    TR.start(str(tmp / "host.rank0.json"),
             jsonl_path=str(tmp / "fault.events.jsonl"))
    try:
        out["fault"] = _traced_fault(engine, prompts, span_dir, journal)
        out["profile"] = _profile_ticks(engine, TL.get(), tmp / "prof")
    finally:
        TR.stop()
    merged = tmp / "merged.json"
    if M.main([str(merged), str(tmp / "host.rank0.json"),
               out["profile"]["profile_path"]]) != 0:
        raise AssertionError("obs.merge failed")
    with open(merged) as f:
        events = json.load(f)
    blocks = {e["pid"] // M.PID_STRIDE for e in events}
    if blocks != {1, 2}:
        raise AssertionError(f"the merged trace's pid blocks: {blocks}")
    out["merged_events"] = len(events)
    del events
    # The HTTP legs, untraced and traced in turns.
    timed: list = []
    inner = engine.step

    def step():
        n = engine.metrics.decode_ticks.value
        t0 = time.monotonic()
        worked = inner()
        if engine.metrics.decode_ticks.value != n:
            timed.append(time.monotonic() - t0)
        return worked

    engine.step = step
    srv = ServingServer(engine, port=0, request_timeout=600).start()
    base = "http://%s:%d" % srv.address
    legs = []
    try:
        for i, name in enumerate(TRACE_LEGS):
            if name == "traced":
                d = tmp / f"leg{i}"
                d.mkdir()
                TR.start(str(d / "trace.json"),
                         jsonl_path=str(d / "events.jsonl"))
                rec = TR.start_spans(
                    str(d / "spans.jsonl"), proc="replica",
                    sampling=TR.SpanSampling(**TRACE_SAMPLING))
            try:
                leg = _http_burst(engine, base, prompts, timed)
                # A reply leaves when its future resolves, just before
                # the engine thread writes the span's finish record.
                deadline = time.monotonic() + 30
                while name == "traced" and rec.n_finished < len(prompts):
                    if time.monotonic() > deadline:
                        raise AssertionError("span finish records missing")
                    time.sleep(0.001)
            finally:
                if name == "traced":
                    TR.stop_spans()
                    TR.stop()
            leg["name"] = name
            if name == "traced":
                leg.update(_check_spans(leg, d / "spans.jsonl",
                                        leg["replies"]))
                leg["jsonl_bytes_per_request"] = \
                    (d / "events.jsonl").stat().st_size / len(prompts)
                leg["span_bytes_per_request"] = \
                    (d / "spans.jsonl").stat().st_size / len(prompts)
            legs.append(leg)
            log(f"tracing leg {i} ({name}) on {card}: burst "
                f"{leg['tok_per_s']:.1f} tok/s, decode "
                f"{leg['decode_tok_per_s']:.1f} tok/s at "
                f"{ENGINE['n_slots']} slots, median decode step "
                f"{leg['tick_wall_ms_median']:.4f} "
                f"ms (max {leg['tick_wall_ms_max']:.3f}, sum "
                f"{leg['tick_wall_ms_sum']:.1f}) over {leg['decode_steps']} "
                f"steps, TTFT p50/max {leg['ttft_ms_p50']:.1f}/"
                f"{leg['ttft_ms_max']:.1f} ms, gc collections by "
                f"generation {leg['gc_collections']} taking "
                f"{leg['gc_ms_total']:.1f} ms (longest "
                f"{leg['gc_ms_max']:.1f}), "
                f"{leg['decode_ticks']} ticks, host syncs a tick "
                f"{leg['host_syncs_per_tick']:.4f}, launches "
                f"{leg['launches']}" + (
                    f", {leg['span_lines_per_request']:.2f} span lines and "
                    f"{leg['jsonl_bytes_per_request']:.0f} JSONL bytes a "
                    f"request" if name == "traced" else ""))
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            text = r.read().decode()
    finally:
        srv.stop()
        del engine.step
    ref = legs[0]
    ref_tokens = [b["tokens"] for b in ref["replies"]]
    for leg in legs:
        if [b["tokens"] for b in leg["replies"]] != ref_tokens:
            raise AssertionError(f"leg {leg['name']}: tokens differ from "
                                 "the untraced leg's")
        if (leg["host_syncs_per_tick"], leg["decode_ticks"]) != \
                (ref["host_syncs_per_tick"], ref["decode_ticks"]):
            raise AssertionError(f"leg {leg['name']}: host syncs a tick "
                                 f"{leg['host_syncs_per_tick']} over "
                                 f"{leg['decode_ticks']} ticks, untraced "
                                 f"{ref['host_syncs_per_tick']} over "
                                 f"{ref['decode_ticks']}")
        g0, g1 = leg.pop("graphs")
        if g0 != g1 or g1["decode_compilations"] != 1:
            raise AssertionError(f"leg {leg['name']} captured: {g0} -> {g1}")
        if not all(n > 0 for n in leg["launches"].values()):
            raise AssertionError(f"leg {leg['name']} missed a kernel: "
                                 f"{leg['launches']}")
        del leg["replies"]
    fams = _prom_parse(text)
    achieved = fams["serving_achieved_flops_per_sec"]["samples"][0][2]
    decode = {s[1].get("fn"): s[2] for s in
              fams["xla_compiles_total"]["samples"]}.get("serving_decode")
    if not achieved > 0:
        raise AssertionError(f"serving_achieved_flops_per_sec {achieved}")
    if decode - decode0 != engine.stats()["decode_compilations"]:
        raise AssertionError(f"xla_compiles_total{{fn=serving_decode}} grew "
                             f"by {decode - decode0}, the engine captured "
                             f"{engine.stats()['decode_compilations']}")
    out["metrics"] = {"families": len(fams),
                      "achieved_flops_per_sec": achieved,
                      "serving_decode_compiles": decode - decode0}
    out["legs"] = legs
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = _traced_train(tmp / "train.json")
    un = [lg for lg in legs if lg["name"] == "untraced"]
    tr = [lg for lg in legs if lg["name"] == "traced"]
    log(f"tracing on {card}: burst tok/s untraced "
        f"{[round(lg['tok_per_s'], 1) for lg in un]} traced "
        f"{[round(lg['tok_per_s'], 1) for lg in tr]}; decode tok/s at "
        f"{ENGINE['n_slots']} slots untraced "
        f"{[round(lg['decode_tok_per_s'], 1) for lg in un]} traced "
        f"{[round(lg['decode_tok_per_s'], 1) for lg in tr]}; median "
        f"decode step ms untraced "
        f"{[round(lg['tick_wall_ms_median'], 4) for lg in un]} "
        f"traced {[round(lg['tick_wall_ms_median'], 4) for lg in tr]}; "
        f"tokens, host syncs a tick ({ref['host_syncs_per_tick']:.4f}) and "
        f"captures equal; fault: {out['fault']['interrupted']} spans with "
        f"engine_restart + resume; profile: {out['profile']['k4_kernels']} "
        f"in {out['profile']['device_kernels']} device kernels; /metrics "
        f"{len(fams)} families, achieved {achieved:.4e} FLOP/s; "
        f"{out['train']['train_step_pairs']} train_step spans")
    return out


# --- the serving fleet: replica processes behind the router ------------------

# The fleet phase: FLEET_REPLICAS replica processes of the serving
# configuration on the one card, each with its own CUDA context (no NCCL
# between them), warmed over the buckets the serving prompts and their
# resumes reach (prompt + emitted: the 2048-token prompt resumes at 2176);
# the rollout's candidate and the canary's one scoring window, whose TTFT
# SLO (5 s) only a stalled canary breaks; the f32 tuner leg's windows
# (worked ticks) and the applies it must reach.
FLEET_REPLICAS = 2
FLEET_DEVICE = "cuda"
FLEET_WARM_LENS = [8, 16, 64, 128, 256, 512, 1024, 2048, 2170]
FLEET_CANDIDATE = {"max_prefills_per_tick": 1}
FLEET_WINDOW_S = 2.0
FLEET_TTFT_SLO_S = 5.0
FLEET_TUNER_WINDOW = 4
FLEET_TUNER_APPLIES = 3
# A victim for the SIGKILL holds a request with at least this many tokens
# still to come, so that its resume carries a partial decode.
FLEET_KILL_REMAINING = 16


def _post_headers(url, payload, timeout=600):
    """POST JSON -> (status, body, headers), an HTTP error read like a
    reply."""
    import urllib.error

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get_json(url, timeout=60):
    import urllib.error

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _memory_used() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


class _Fleet:
    """``FLEET_REPLICAS`` replicas of one ``dump_model`` pickle under a
    ``ReplicaSupervisor`` (journals, span streams and logs under
    ``root``), behind a ``RouterServer`` with ``resume_lookup`` and the
    span store, and a ``RolloutController`` when ``rollout``."""

    def __init__(self, root: Path, pkl: str, rollout: bool = False):
        from horovod_tpu_torch.serving.router import (ReplicaRegistry,
                                                      ReplicaSpec,
                                                      ReplicaSupervisor,
                                                      RolloutController,
                                                      RouterServer)
        from horovod_tpu_torch.tuning import Objective

        self.root = root
        spec = ReplicaSpec(
            params_path=pkl, slots=ENGINE["n_slots"],
            max_prefills_per_tick=ENGINE["max_prefills_per_tick"],
            max_queue_depth=ENGINE["max_queue_depth"], tick_timeout=120.0,
            request_timeout=600.0, drain_timeout=60.0,
            warm=tuple(FLEET_WARM_LENS), device=FLEET_DEVICE,
            # Latency alone keeps no tick detail: only the resume path.
            extra_args=("--span-latency-threshold", "600"))
        self.reg = ReplicaRegistry(poll_interval=0.1, poll_timeout=5.0,
                                   heartbeat_stale=60.0)
        self.sup = ReplicaSupervisor(
            spec, FLEET_REPLICAS, registry=self.reg, startup_timeout=600.0,
            unhealthy_grace=30.0, shutdown_grace=60.0, backoff_initial=0.1,
            journal_dir=str(root / "journal"), span_dir=str(root / "spans"),
            log_dir=str(root / "logs"))
        self.ctl = None
        if rollout:
            self.ctl = RolloutController(
                self.sup, window_s=FLEET_WINDOW_S, canary_windows=1,
                ready_timeout=600.0, drain_margin=30.0,
                objective=Objective(
                    ttft_slo={"interactive": FLEET_TTFT_SLO_S}))
        self.rt = RouterServer(self.reg, port=0, max_attempts=4,
                               retry_backoff=0.05, proxy_timeout=600.0,
                               resume_lookup=self.sup.resume_lookup,
                               span_dir=str(root / "spans"),
                               rollout=self.ctl)
        self.ready_s: dict = {}

    def start(self) -> "_Fleet":
        self.sup.start()
        self.rt.start()
        self.base = "http://%s:%d" % self.rt.address
        self.wait_ready()
        return self

    def wait_ready(self, timeout: float = 600.0) -> dict:
        """Block until every live replica is in rotation; each one's
        seconds from spawn to routable (its imports, the pickle, the
        warmup's captures) are kept by replica id."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            handles = self.sup.replicas()
            for h in handles:
                if h.rid not in self.ready_s and self.reg.is_routable(h.rid):
                    self.ready_s[h.rid] = time.monotonic() - h.spawned_at
            if len(handles) == FLEET_REPLICAS and all(
                    h.rid in self.ready_s for h in handles):
                return self.ready_s
            time.sleep(0.05)
        raise AssertionError(f"fleet replicas never ready\n{self.tails()}")

    def stats(self) -> dict:
        """Every routable replica's /stats, by replica id."""
        out = {}
        for st in self.reg.in_rotation():
            code, body = _get_json(st.endpoint.base_url + "/stats")
            if code == 200:
                out[st.endpoint.rid] = body
        return out

    def tails(self, n: int = 3000) -> str:
        logs = sorted((self.root / "logs").glob("*.log"))
        return "\n".join(f"--- {p.name} (last {n} bytes)\n"
                         + p.read_text(errors="replace")[-n:] for p in logs)

    def check(self, ok: bool, msg: str) -> None:
        """A failed gate raises with every replica log's tail."""
        if not ok:
            raise AssertionError(f"{msg}\n{self.tails()}")

    def stop(self) -> None:
        self.rt.stop()
        self.sup.stop(drain=False)


def _fleet_burst(fleet: _Fleet, prompts, new_tokens, sampling,
                 during=None) -> dict:
    """The prompts concurrently through the router, ``during(done)``
    called from this thread once they are sent (``done`` the indices
    answered so far).  Every request must return 200 with its full
    count."""
    url = fleet.base + "/generate"
    results: list = [None] * len(prompts)
    t0 = time.monotonic()

    def client(i):
        res = _post_headers(url, {"tokens": prompts[i],
                                  "max_new_tokens": new_tokens[i],
                                  **sampling[i]})
        results[i] = (*res, time.monotonic())

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    extra = during(lambda: [i for i, r in enumerate(results) if r]) \
        if during else None
    for t in threads:
        t.join(900)
    wall = time.monotonic() - t0
    for i, r in enumerate(results):
        fleet.check(r is not None and r[0] == 200
                    and len(r[1].get("tokens", ())) == new_tokens[i],
                    f"fleet request {i}: {r and r[:2]}")
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    served = {}
    for r in results:
        rid = r[2].get("X-Router-Replica")
        served[rid] = served.get(rid, 0) + 1
    return {"wall_s": wall, "tokens": sum(new_tokens),
            "tok_per_s": sum(new_tokens) / wall,
            "ttft_ms_p50": statistics.median(ttft), "ttft_ms_max": ttft[-1],
            "served_by": served, "results": results, "during": extra}


def _fleet_deltas(fleet: _Fleet, before: dict, after: dict) -> dict:
    """Per replica alive at both reads: K1's and K4's launches in its
    process between them; the leg's gates: both grew, one tick capture,
    no admission or sampler capture."""
    out = {}
    for rid in sorted(set(before) & set(after)):
        b, a = before[rid], after[rid]
        d = {k: a[k] - b[k] for k in ("flash_fwd_launches",
                                      "paged_attend_launches")}
        fleet.check(all(v > 0 for v in d.values()),
                    f"replica {rid} missed a kernel: {d}")
        fleet.check(a["decode_compilations"] == 1,
                    f"replica {rid}: {a['decode_compilations']} tick "
                    "captures")
        for k in ("prefill_compilations", "sample_compilations"):
            fleet.check(a[k] == b[k], f"replica {rid} captured after "
                        f"warmup: {k} {b[k]} -> {a[k]}")
        out[rid] = d
    return out


def _kill_mid_burst(fleet: _Fleet, n: int):
    """The ``during`` hook of the SIGKILL leg: once every request has
    tokens (a live journal entry with one, or a reply), SIGKILL the
    replica holding the most requests with ``FLEET_KILL_REMAINING``
    tokens still to come.  Returns (victim handle, kill time)."""
    import os
    import signal

    from horovod_tpu_torch.serving import RequestJournal

    def hook(done):
        seen = set()
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            busy = []
            for h in fleet.sup.replicas():
                try:
                    live = RequestJournal.read_live(
                        fleet.sup._journal_paths[h.rid])
                except Exception:
                    continue
                n_mid = 0
                for tid, d in live.items():
                    got = len(d["emitted_tokens"])
                    if got:
                        seen.add(tid)
                    if got and d["max_new_tokens"] - got >= \
                            FLEET_KILL_REMAINING:
                        n_mid += 1
                busy.append((n_mid, h))
            if len(seen) + len(done()) >= n and any(b for b, _ in busy):
                _, victim = max(busy, key=lambda x: x[0])
                t_kill = time.monotonic()
                os.kill(victim.pid, signal.SIGKILL)
                return victim, t_kill
            time.sleep(0.002)
        raise AssertionError(f"no replica held a request mid-decode\n"
                             f"{fleet.tails()}")

    return hook


def _autopsy(fleet: _Fleet, tid: str) -> dict:
    """``GET /trace/<tid>`` of a resumed request: one tree holding the
    killed attempt's unfinished ``generate`` span and the survivor's,
    the resume edge from the journal linked to the dead span."""
    def walk(node):
        yield node
        for c in node["children"]:
            yield from walk(c)

    code, a = _get_json(f"{fleet.base}/trace/{tid}")
    fleet.check(code == 200, f"/trace/{tid}: {code} {a}")
    spans = [s for root in a["tree"] for s in walk(root)]
    gen = [s for s in spans if s["name"] == "generate"]
    dead = [s for s in gen if s["unfinished"]]
    resume = [e for e in a["events"] if e["type"] == "resume"
              and e["attrs"].get("source") == "journal"]
    fleet.check(a["resumed"] is True and a["failovers"] >= 1
                and a["carried_tokens"] >= 1 and len(a["tree"]) == 1
                and len(gen) >= 2 and dead and resume
                and resume[0]["attrs"]["resumed_from_span"]
                in {s["span_id"] for s in dead},
                f"the autopsy of {tid}: {json.dumps(a)[:3000]}")
    return {"processes": a["processes"], "failovers": a["failovers"],
            "carried_tokens": a["carried_tokens"],
            "generate_spans": len(gen), "unfinished": len(dead)}


def fleet_full_width(card: str, tmp: Path, single: dict) -> dict:
    """The bf16 fleet's three legs: clean, SIGKILL, rollout under load
    (see the module docstring).  ``single``: the serving phase's burst,
    printed beside the router's."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.obs import tracing as TR
    from horovod_tpu_torch.serving.router.replica_main import dump_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = T.TransformerConfig(**FULL, dtype=torch.bfloat16)
    pkl = str(tmp / "bf16.pkl")
    params = T.init_params(cfg, seed=0)
    dump_model(pkl, params, cfg)
    del params
    torch.cuda.empty_cache()
    prompts = _prompts()
    fleet = _Fleet(tmp / "bf16", pkl, rollout=True)
    TR.start_spans(str(tmp / "bf16" / "spans" / "router.spans.jsonl"),
                   proc="router", role="router",
                   sampling=TR.SpanSampling(latency_threshold_s=600.0))
    out = {"replicas": FLEET_REPLICAS, "warm_lens": FLEET_WARM_LENS}
    try:
        fleet.start()
        st = fleet.stats()
        out["ready_s"] = dict(fleet.ready_s)
        out["warmup_reserved_bytes"] = {
            rid: s["warmup_reserved_bytes"] for rid, s in st.items()}
        out["memory_used"] = _memory_used()
        log(f"fleet on {card}: {FLEET_REPLICAS} replicas ready, seconds "
            f"from spawn {out['ready_s']}; warmup_reserved_bytes "
            f"{out['warmup_reserved_bytes']}; nvidia-smi memory.used "
            f"{out['memory_used']} (the smoke process included)")
        # Leg 1: the clean burst.
        before = fleet.stats()
        clean = _fleet_burst(fleet, prompts, NEW_TOKENS, SAMPLING)
        after = fleet.stats()
        fleet.check(len(clean["served_by"]) == FLEET_REPLICAS,
                    f"one replica served every request: "
                    f"{clean['served_by']}")
        clean["launches"] = _fleet_deltas(fleet, before, after)
        del clean["results"]
        out["clean"] = clean
        log(f"fleet clean (bf16) on {card}: {clean['tok_per_s']:.1f} "
            f"tok/s, TTFT p50 {clean['ttft_ms_p50']:.1f} ms max "
            f"{clean['ttft_ms_max']:.1f} ms, served by "
            f"{clean['served_by']}; one engine (the serving phase's "
            f"burst): {single['tok_per_s']:.1f} tok/s, TTFT p50 "
            f"{single['ttft_ms_p50']:.1f} ms max "
            f"{single['ttft_ms_max']:.1f} ms; launches {clean['launches']}")
        # Leg 2: SIGKILL a replica once every request has tokens.
        before = fleet.stats()
        kill = _fleet_burst(fleet, prompts, NEW_TOKENS, SAMPLING,
                            during=_kill_mid_burst(fleet, len(prompts)))
        victim, t_kill = kill["during"]
        last = max(r[3] for r in kill["results"])
        resumed = [(i, r[1]) for i, r in enumerate(kill["results"])
                   if r[1].get("resumed")]
        fleet.check(bool(resumed), "no reply resumed after the SIGKILL")
        failovers = fleet.reg.metrics.resume_failovers.value
        fleet.check(failovers >= 1, "router_resume_failovers_total is 0")
        wasted = sum(len(prompts[i]) + body["resume_carried_tokens"]
                     for i, body in resumed)
        deadline = time.monotonic() + 600.0
        while True:
            h = fleet.sup.handle(victim.slot)
            if h is not None and h.gen > victim.gen \
                    and fleet.reg.is_routable(h.rid):
                break
            fleet.check(time.monotonic() < deadline,
                        f"slot {victim.slot} never rejoined")
            time.sleep(0.05)
        rejoin = time.monotonic() - t_kill
        fleet.wait_ready()
        autopsy = _autopsy(fleet, resumed[0][1]["trace_id"])
        after = fleet.stats()
        kill_out = {
            "victim": victim.rid, "respawned_as": h.rid,
            "tok_per_s": kill["tok_per_s"], "wall_s": kill["wall_s"],
            "kill_to_last_reply_s": last - t_kill,
            "kill_to_rejoin_s": rejoin, "resumed_replies": len(resumed),
            "resume_failovers": failovers,
            "resume_wasted_tokens": wasted,
            "served_by": kill["served_by"], "autopsy": autopsy,
            "launches": {rid: {k: after[rid][k] - before[rid][k]
                               for k in ("flash_fwd_launches",
                                         "paged_attend_launches")}
                         for rid in set(before) & set(after)}}
        out["sigkill"] = kill_out
        log(f"fleet SIGKILL (bf16) on {card}: killed {victim.rid} once "
            f"every request had tokens; {len(prompts)} of {len(prompts)} "
            f"full counts, {len(resumed)} resumed, "
            f"router_resume_failovers_total {failovers}; kill to last reply "
            f"{kill_out['kill_to_last_reply_s']:.3f} s, kill to rejoin "
            f"({h.rid}) {rejoin:.3f} s; resume_wasted_tokens {wasted} "
            f"(prompt + carried, re-prefilled); /trace: "
            f"{autopsy['generate_spans']} generate spans, "
            f"{autopsy['unfinished']} unfinished, processes "
            f"{autopsy['processes']}")
        # Leg 3: the rollout under load.
        out["rollout"] = _rollout_leg(fleet, prompts, card)
    finally:
        fleet.stop()
        TR.stop_spans()
    return out


def _rollout_leg(fleet: _Fleet, prompts, card: str) -> dict:
    """``POST /rollout`` of ``FLEET_CANDIDATE`` while bursts run back to
    back: the rollout ends ``done``, every replica reads
    ``config_generation`` 1, every request of every burst returns its
    full count."""
    stop = threading.Event()
    bursts: list = []
    errors: list = []

    def load():
        while not stop.is_set():
            try:
                bursts.append(_fleet_burst(fleet, prompts, NEW_TOKENS,
                                           SAMPLING))
            except AssertionError as e:
                errors.append(str(e))
                return

    t = threading.Thread(target=load)
    t.start()
    time.sleep(1.0)
    t0 = time.monotonic()
    code, body, _ = _post_headers(fleet.base + "/rollout",
                                  {"candidate": FLEET_CANDIDATE})
    fleet.check(code == 202, f"POST /rollout: {code} {body}")
    fleet.ctl.wait(900.0)
    duration = time.monotonic() - t0
    stop.set()
    t.join(900)
    fleet.check(not errors, f"a request failed during the rollout: "
                f"{errors[:1]}")
    _, status = _get_json(fleet.base + "/rollout")
    fleet.check(status["state"] == "done", f"rollout ended {status}")
    fleet.wait_ready()
    gens = {rid: s["config_generation"] for rid, s in fleet.stats().items()}
    fleet.check(len(gens) == FLEET_REPLICAS
                and set(gens.values()) == {1},
                f"config generations after the rollout: {gens}")
    n = sum(len(b["results"]) for b in bursts)
    out = {"candidate": FLEET_CANDIDATE, "duration_s": duration,
           "state": status["state"], "step_durations_s":
           status["step_durations_s"], "config_generations": gens,
           "bursts": len(bursts), "requests": n, "dropped": 0,
           "canary_score": status["canary_score"],
           "incumbent_score": status["incumbent_score"]}
    log(f"fleet rollout (bf16) on {card}: {FLEET_CANDIDATE} "
        f"{status['state']} in {duration:.3f} s (steps "
        f"{status['step_durations_s']}); config_generation {gens}; "
        f"{n} requests in {len(bursts)} bursts during it, none dropped")
    return out


def fleet_identity_f32(card: str, tmp: Path, oracle: dict) -> dict:
    """Leg 4, beside ``token_identity_f32`` (TF32 off in the replicas,
    PyTorch's default): a 2-replica f32 fleet serves that phase's prompts,
    half sampled, with a SIGKILL once every request has tokens; every
    reply, resumed ones included, equals ``_f32_oracles`` by the same
    near-tie rule.  Then in this process an f32 engine with
    ``autotune=True`` and ``FLEET_TUNER_WINDOW``-tick windows serves
    bursts of the same prompts until its tuner has applied
    ``FLEET_TUNER_APPLIES`` settings: every burst's tokens equal the
    oracles, no capture after warmup."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving import EngineConfig, InferenceEngine
    from horovod_tpu_torch.serving.router.replica_main import dump_model
    from horovod_tpu_torch.tuning import tuner as tuner_mod

    prompts, refs, params, cfg = (oracle["prompts"], oracle["refs"],
                                  oracle["params"], oracle["cfg"])
    new = [F32_NEW_TOKENS] * len(prompts)
    pkl = str(tmp / "f32.pkl")
    dump_model(pkl, params, cfg)
    fleet = _Fleet(tmp / "f32", pkl)
    try:
        fleet.start()
        kill = _fleet_burst(fleet, prompts, new, SAMPLING,
                            during=_kill_mid_burst(fleet, len(prompts)))
        outs = [r[1]["tokens"] for r in kill["results"]]
        resumed = sum(bool(r[1].get("resumed")) for r in kill["results"])
        fleet.check(resumed >= 1, "no f32 reply resumed")
        exempt = _check_f32("f32 fleet", prompts, outs, refs)
    finally:
        fleet.stop()
    fleet_out = {"ready_s": dict(fleet.ready_s), "resumed": resumed,
                 "exemptions": exempt, "tok_per_s": kill["tok_per_s"],
                 "victim": kill["during"][0].rid}
    log(f"fleet f32 on {card}: SIGKILL of {fleet_out['victim']} mid-burst, "
        f"{resumed} resumed; {len(prompts)} replies equal the oracles "
        f"({len(exempt)} near-tie exemptions)")
    # The online tuner in this process, small windows.
    engine = InferenceEngine(params, cfg, EngineConfig(**ENGINE,
                                                       autotune=True))
    engine.warmup(FLEET_WARM_LENS)
    # Installed by warmup() at the default 32-tick windows; the leg's
    # bursts are short, so it is reinstalled over the same space.
    engine._tuner = None
    tuner = tuner_mod.OnlineTuner.install(
        engine, window_ticks=FLEET_TUNER_WINDOW, warmup_windows=0,
        bo_samples=4)
    applied: list = []
    orig = tuner_mod.apply_settings

    def counting(eng, settings):
        applied.append(dict(settings))
        return orig(eng, settings)

    keys = ("decode_compilations", "prefill_compilations",
            "sample_compilations")
    warm = {k: engine.stats()[k] for k in keys}
    tuner_mod.apply_settings = counting
    exempt, bursts = [], 0
    try:
        while len(applied) < FLEET_TUNER_APPLIES and bursts < 6:
            futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS,
                                  **SAMPLING[i])
                    for i, p in enumerate(prompts)]
            while not all(f.done() for f in futs):
                engine.step()
            bursts += 1
            exempt += _check_f32(f"f32 tuned burst {bursts}", prompts,
                                 [f.result(timeout=0) for f in futs], refs)
    finally:
        tuner_mod.apply_settings = orig
    now = {k: engine.stats()[k] for k in keys}
    if len(applied) < FLEET_TUNER_APPLIES:
        raise AssertionError(f"the tuner applied {applied} in {bursts} "
                             "bursts")
    if now != warm or warm["decode_compilations"] != 1:
        raise AssertionError(f"captures under the tuner: {warm} -> {now}")
    snap = tuner.snapshot()
    del engine
    torch.cuda.empty_cache()
    out = {"fleet": fleet_out, "tuner": {
        "bursts": bursts, "applied": applied, "phase": snap["phase"],
        "samples": snap["samples"], "exemptions": exempt,
        "captures": now}}
    log(f"online tuner f32 on {card}: {len(applied)} applies {applied} in "
        f"{bursts} bursts (phase {snap['phase']}, {snap['samples']} "
        f"samples); tokens equal the oracles ({len(exempt)} near-tie "
        f"exemptions); captures {now}, as after warmup")
    return out


# --- the vision phase: ResNet-50 in bench.py's protocol ------------------------

# bench.py's protocol: 10 warm-up batches, 10 iterations of 10 batches.
# Each leg: (batch, run the captured step or its eager body, bf16 gradient
# reduction).  The batch-384 legs are the JAX bench's default, batch 64 the
# reference's batch a GPU (BASELINE.md).
VISION_LEGS = {"b384_eager": (384, False, False),
               "b384_captured": (384, True, False),
               "b64_eager": (64, False, False),
               "b64_captured": (64, True, False),
               "b64_captured_fp16_allreduce": (64, True, True)}
VISION_SIZE = 224
VISION_GAP_STEPS, VISION_GAP = 10, 1e-3
# The f32 check: CUDA against the CPU, each error relative to the largest
# magnitude of the tensor compared (cuDNN's and the CPU's algorithms sum in
# other orders; a gradient also moves where a pre-activation within that
# rounding of zero falls on the other side of a relu).
VISION_F32_BATCH = 4
VISION_F32_TOL = {"logits": 1e-3, "loss": 1e-4, "grad": 1e-2,
                  "batch_stats": 1e-3, "s2d_logits": 1e-3}
INCEPTION_SIZE, INCEPTION_BATCH = 299, 64
MLP_BATCH, MLP_STEPS = 128, 20


def _rel(got, want) -> float:
    return ((got.float().cpu() - want.float().cpu()).abs().max()
            / want.float().cpu().abs().max().clamp_min(1e-30)).item()


def vision_f32_check() -> dict:
    """Full ResNet-50 (1000 classes) in f32 from ``init_variables`` seed 0,
    batch 4 at 224 × 224, ``conv7`` stem, train mode: the port on CUDA
    against the same model and weights on the CPU (the tier-1 tests hold
    the CPU against flax): logits, loss, every gradient and the batch
    statistics the forward moved; then one forward of the ``s2d`` stem.
    TF32 is off for the check and restored after it."""
    import copy

    from horovod_tpu_torch.models import resnet

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        errs = {}
        g = torch.Generator().manual_seed(4)
        x = torch.rand((VISION_F32_BATCH, 3, VISION_SIZE, VISION_SIZE),
                       generator=g)
        y = torch.randint(0, 1000, (VISION_F32_BATCH,), generator=g)
        for stem in ("conv7", "s2d"):
            gpu = resnet.create("ResNet50", 1000, torch.float32, stem,
                                seed=0, device="cuda").train()
            cpu = copy.deepcopy(gpu).to("cpu")
            outs = {}
            for name, m in (("cuda", gpu), ("cpu", cpu)):
                dev = next(m.parameters()).device
                xb = x.to(dev).contiguous(memory_format=torch.channels_last)
                logits = m(xb)
                if stem == "conv7":
                    loss = torch.nn.functional.cross_entropy(logits,
                                                             y.to(dev))
                    loss.backward()
                    outs[name] = (logits, loss)
                else:
                    outs[name] = (logits.detach(), None)
            if stem == "s2d":
                errs["s2d_logits"] = _rel(outs["cuda"][0], outs["cpu"][0])
                continue
            errs["logits"] = _rel(outs["cuda"][0], outs["cpu"][0])
            errs["loss"] = _rel(outs["cuda"][1], outs["cpu"][1])
            pc = dict(cpu.named_parameters())
            grads = {n: _rel(p.grad, pc[n].grad)
                     for n, p in gpu.named_parameters()}
            worst = max(grads, key=grads.get)
            errs["grad"] = grads[worst]
            bc = dict(cpu.named_buffers())
            stats = {n: _rel(b, bc[n]) for n, b in gpu.named_buffers()}
            errs["batch_stats"] = max(stats.values())
            log(f"vision f32 (ResNet-50, batch {VISION_F32_BATCH}, "
                f"{VISION_SIZE}², TF32 off), CUDA against the CPU: worst "
                f"gradient {worst}")
            del gpu, cpu, outs
        for k, e in errs.items():
            log(f"vision f32 {k}: max relative error {e:.3e} (tolerance "
                f"{VISION_F32_TOL[k]:.0e})")
        bad = {k: e for k, e in errs.items() if not e <= VISION_F32_TOL[k]}
        if bad:
            raise AssertionError(f"vision f32: CUDA and the CPU disagree: "
                                 f"{bad}")
        return errs
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
        _collect()


def _resnet_step(batch: int, fp16_allreduce: bool = False):
    """A fresh ResNet-50 (``init_variables`` seed 0), its bench step and
    the fixed synthetic batch (seed 0)."""
    from horovod_tpu_torch import bench

    model = bench.create_model("ResNet50", seed=0, device="cuda")
    step = bench.make_step(model, fp16_allreduce=fp16_allreduce)
    return model, step, bench.synthetic_batch(batch, VISION_SIZE,
                                              device="cuda")


def _collect() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def vision_gap() -> dict:
    """Batch 64 under ``cudnn.deterministic`` (benchmark off): the first
    ``VISION_GAP_STEPS`` losses of the eager body and of the captured step,
    each from a fresh model of the same seed on the same batch, within
    ``VISION_GAP`` relative."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        losses = {}
        for mode in ("eager", "captured"):
            model, step, batch = _resnet_step(64)
            run = step if mode == "captured" else step.body
            losses[mode] = [float(run(model, batch))
                            for _ in range(VISION_GAP_STEPS)]
            del model, step, batch, run
            _collect()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    gap = max(abs(a - b) / abs(b) for a, b in
              zip(losses["captured"], losses["eager"]))
    log(f"vision batch 64, cudnn.deterministic: eager losses "
        f"{[round(v, 5) for v in losses['eager']]}; largest gap of the "
        f"captured step {gap:.3e} (limit {VISION_GAP:.0e} relative)")
    if not gap <= VISION_GAP:
        raise AssertionError(f"vision: captured and eager losses differ by "
                             f"{gap:.3e}")
    return {"losses": losses, "gap": gap}


def _check_losses(label: str, losses: list) -> None:
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")


def _check_capture(label: str, step) -> None:
    """One capture, made after ``WARMUP_STEPS`` eager steps of the same
    shapes (which ran cuDNN's autotuning: a benchmark inside a capture
    would fail it), and every later call a replay."""
    from horovod_tpu_torch import spmd

    if step.captures != 1 or step.replays != step.calls - spmd.WARMUP_STEPS:
        raise AssertionError(f"{label}: {step.captures} captures, "
                             f"{step.replays} replays of {step.calls} calls")


def _vision_summary(label, res, batch, step, captured, peak) -> dict:
    from horovod_tpu_torch import bench

    out = dict(bench.summarize(res, batch_size=batch, peak=peak),
               losses=res["losses"], peak_mem_bytes=res["peak_mem_bytes"],
               captures=step.captures, replays=step.replays,
               img_per_sec=res["img_per_sec"])
    _check_losses(label, res["losses"])
    if captured:
        _check_capture(label, step)
    if out["mfu"] is None or not 0 < out["mfu"] < 1:
        raise AssertionError(f"{label}: MFU {out['mfu']} (a reading of 1 "
                             "or more is a fault in the FLOP count)")
    return out


def vision_leg(name: str, card: str, host=None) -> dict:
    """One ResNet-50 leg of ``VISION_LEGS`` in bench.py's protocol, with
    ``cudnn.benchmark`` on; the batch-384 legs also profile one more step,
    and with ``host`` the captured leg runs the loader-fed A/B."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.data import DataLoader
    from horovod_tpu_torch.obs import xprof

    t0 = time.monotonic()
    batch, captured, fp16 = VISION_LEGS[name]
    model, step, data = _resnet_step(batch, fp16)
    run = step if captured else step.body
    loader = None
    if host is not None:
        loader = DataLoader(host, batch, shuffle=False, shard=False,
                            prefetch=2, device="cuda")
    res = bench.measure(run, model, data, warmup=10, per_iter=10, iters=10,
                        loader=loader)
    out = _vision_summary(f"vision [{name}]", res, batch, step, captured,
                          xprof.chip_peak_flops())
    if loader is not None:
        if not all(math.isfinite(v) for v in res["fed_losses"]):
            raise AssertionError(f"vision [{name}]: a loader-fed loss is "
                                 f"not finite: {res['fed_losses']}")
        fed = statistics.median(res["fed_img_per_sec"])
        link = bench.link_bound(host, batch, torch.device("cuda"))
        out.update(fed_img_per_sec=fed,
                   overhead_pct=100 * (1 - fed / out["value"]),
                   host_to_device_bound_img_per_sec=link,
                   efficiency_vs_ceiling_pct=100 * fed / min(out["value"],
                                                             link))
    if batch == 384:
        out["profile"] = profile_train_step(run, model, data, flash=False)
    out["seconds"] = time.monotonic() - t0
    log(f"vision [{name}] on {card} ({out['seconds']:.1f} s): "
        f"{out['value']:.1f} img/s "
        f"(±{out['stddev95']:.1f}), MFU {out['mfu']:.4f} "
        f"({out['flops_per_img'] / 1e9:.2f} GFLOP an image counted), peak "
        f"{out['peak_mem_bytes'] / 1e9:.2f} GB, captures {step.captures}, "
        f"replays {step.replays}, losses "
        f"{[round(v, 4) for v in res['losses'][:3]]} … "
        f"{round(res['losses'][-1], 4)}"
        + (f"; loader-fed {out['fed_img_per_sec']:.1f} img/s (overhead "
           f"{out['overhead_pct']:.2f} %, host→device bound "
           f"{out['host_to_device_bound_img_per_sec']:.0f} img/s, "
           f"efficiency {out['efficiency_vs_ceiling_pct']:.2f} %)"
           if loader is not None else ""))
    return out


def inception_leg(card: str) -> dict:
    """InceptionV3 at 299, batch 64, captured, in a shortened protocol
    (10 warm-up batches, 3 iterations of 10)."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.obs import xprof

    t0 = time.monotonic()
    model = bench.create_model("InceptionV3", seed=0, device="cuda")
    step = bench.make_step(model)
    data = bench.synthetic_batch(INCEPTION_BATCH, INCEPTION_SIZE,
                                 device="cuda")
    res = bench.measure(step, model, data, warmup=10, per_iter=10, iters=3)
    out = _vision_summary("vision [inception]", res, INCEPTION_BATCH, step,
                          True, xprof.chip_peak_flops())
    out["seconds"] = time.monotonic() - t0
    log(f"vision [InceptionV3 {INCEPTION_SIZE}², batch {INCEPTION_BATCH}, "
        f"captured] on {card} ({out['seconds']:.1f} s): "
        f"{out['value']:.1f} img/s (±{out['stddev95']:.1f}), MFU "
        f"{out['mfu']:.4f} ({out['flops_per_img'] / 1e9:.2f} GFLOP an "
        f"image), peak {out['peak_mem_bytes'] / 1e9:.2f} GB")
    return out


def mlp_leg() -> dict:
    """The MLP (784-256-128-10) for ``MLP_STEPS`` captured Adam steps fed
    by the DataLoader from host rows whose labels a fixed linear map
    decides: the loss must fall."""
    from horovod_tpu_torch import optim, spmd
    from horovod_tpu_torch.data import DataLoader
    from horovod_tpu_torch.models import mlp

    rng = np.random.default_rng(0)
    x = rng.standard_normal((MLP_BATCH * MLP_STEPS, 784), dtype=np.float32)
    y = (x @ rng.standard_normal((784, 10), dtype=np.float32)).argmax(1)
    loader = DataLoader({"x": x, "y": y}, MLP_BATCH, seed=0, device="cuda")
    params = mlp.init_params(seed=0, device="cuda")
    for t in params.values():
        t.requires_grad_()
    step = spmd.make_train_step(
        lambda p, b: mlp.loss_fn(p, (b["x"], b["y"])),
        optim.DistributedOptimizer(torch.optim.Adam(params.values(),
                                                    lr=1e-3)))
    losses = [float(step(params, b)) for b in loader]
    log(f"vision [mlp]: {len(losses)} loader-fed steps, losses "
        f"{[round(v, 4) for v in losses]}")
    if len(losses) != MLP_STEPS:
        raise AssertionError(f"mlp: {len(losses)} batches")
    _check_losses("vision [mlp]", losses)
    _check_capture("vision [mlp]", step)
    return {"losses": losses, "captures": step.captures,
            "replays": step.replays}


def vision_full_width(card: str) -> dict:
    """The vision phase on a size-1 NCCL group: the f32 check, the
    deterministic eager-against-captured gap, the ResNet-50 legs (the
    batch-384 captured leg with the loader-fed A/B), InceptionV3 and the
    MLP."""
    from horovod_tpu_torch import basics, bench

    _collect()
    t0 = time.monotonic()
    out = {"f32": vision_f32_check()}
    log(f"vision f32 check: {time.monotonic() - t0:.1f} s")
    saved = torch.backends.cudnn.benchmark
    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        out["gap"] = vision_gap()
        torch.backends.cudnn.benchmark = True
        host = bench.host_epoch(384 * 10, VISION_SIZE)
        out["legs"] = {}
        for name in VISION_LEGS:
            out["legs"][name] = vision_leg(
                name, card, host if name == "b384_captured" else None)
            _collect()
        del host
        out["inception"] = inception_leg(card)
        _collect()
        out["mlp"] = mlp_leg()
    finally:
        torch.backends.cudnn.benchmark = saved
        basics.shutdown()
    return out


# --- the collectives at size 1 ------------------------------------------------


def check_collectives(device) -> list:
    """Every collective of the port on ``device`` tensors in f32 and
    bf16, in a job of size 1 (``basics.init`` already called): each
    result must equal its size-1 value exactly.  At size 1 this proves
    the backend's paths on the device's tensors and dtypes, not the
    arithmetic across ranks (the CPU tests hold that against JAX)."""
    from horovod_tpu_torch import join, state
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import sparse as SP
    from horovod_tpu_torch.ops.compression import Compression

    checked = []

    def same(label, got, want):
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"collective {label}: {got} != {want}")
        checked.append(label)

    g = torch.Generator(device=device).manual_seed(5)
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt)[6:]
        x = torch.randn((96, 33), generator=g, device=device).to(dt)
        for op in ("Sum", "Average", "Min", "Max", "Product", "Adasum"):
            same(f"allreduce.{op}.{tag}", C.allreduce(x, op), x)
            same(f"allreduce.{op}.scaled.{tag}",
                 C.allreduce(x, op, prescale_factor=0.5,
                             postscale_factor=3.0),
                 x.clone().mul_(0.5).mul_(3.0))
            h = C.allreduce_async(x, op)
            C.poll(h)
            same(f"allreduce_async.{op}.{tag}", C.synchronize(h), x)
        with C._hierarchical(True):
            same(f"hierarchical.allreduce.{tag}", C.allreduce(x, "Sum"), x)
            same(f"hierarchical.allgather.{tag}", C.allgather(x), x)
        same(f"allreduce.compression.{tag}",
             C.allreduce(x.float(), "Sum", compression=Compression.bf16),
             x.float().to(torch.bfloat16).float())
        same(f"process_sum.{tag}", C.process_sum(x), x)
        for op in ("Average", "Adasum"):
            for i, t in enumerate(C.grouped_allreduce([x, x[:7, :5]], op)):
                same(f"grouped.{op}.{i}.{tag}", t, [x, x[:7, :5]][i])
        same(f"allgather.{tag}", C.allgather(x), x)
        same(f"broadcast.{tag}", C.broadcast(x, 0), x)
        same(f"alltoall.{tag}", C.alltoall(x), x)
        same(f"alltoall.splits.{tag}", C.alltoall(x, [x.shape[0]]), x)
        for op in ("Sum", "Average"):
            same(f"reducescatter.{op}.{tag}", C.reducescatter(x, op), x)
        for label, h in (("allgather_async", C.allgather_async(x)),
                         ("broadcast_async", C.broadcast_async(x, 0)),
                         ("reducescatter_async",
                          C.reducescatter_async(x, "Sum")),
                         ("alltoall_async", C.alltoall_async(x)),
                         ("alltoall_async.splits",
                          C.alltoall_async(x, [x.shape[0]]))):
            C.poll(h)
            same(f"{label}.{tag}", C.synchronize(h), x)
            if not C.poll(h):
                raise AssertionError(f"{label}: a spent handle polls busy")
            try:
                C.synchronize(h)
            except ValueError:
                pass
            else:
                raise AssertionError(f"{label}: a handle synchronized twice")
        sp = torch.zeros((64, 8), device=device, dtype=dt)
        sp[[3, 17, 40]] = torch.randn((3, 8), generator=g,
                                      device=device).to(dt)
        for op in ("Sum", "Average"):
            got, stats = SP.sparse_allreduce(sp, op, return_stats=True)
            same(f"sparse_allreduce.{op}.{tag}", got, sp)
            same(f"sparse_vs_dense.{op}.{tag}", got, C.allreduce(sp, op))
            if stats["rows"] != 3:
                raise AssertionError(f"sparse rows {stats}")
        for active in (0, 1):
            got = join.masked_average([x], active)[0]
            same(f"masked_average.active{active}.{tag}", got,
                 x if active else torch.zeros_like(x))
            if not torch.isfinite(got.float()).all():
                raise AssertionError("masked_average is not finite")
    obj = {"step": 7, "name": "card", "t": [1.5, 2]}
    if state.broadcast_object(obj, 0) != obj:
        raise AssertionError("broadcast_object")
    if state.allgather_object(obj) != [obj]:
        raise AssertionError("allgather_object")
    checked += ["broadcast_object", "allgather_object"]
    if join.join() != 0:
        raise AssertionError("join() at size 1 must return 0")
    checked.append("join")
    C.barrier()
    checked.append("barrier")
    return checked


def collectives_size_one() -> dict:
    """The collectives phase: a size-1 NCCL group on the card."""
    from horovod_tpu_torch import basics

    basics.init(init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        checked = check_collectives(basics.device())
    finally:
        basics.shutdown()
    log(f"collectives at size 1 over NCCL, f32 and bf16, each equal to its "
        f"size-1 value: {len(checked)} checks: "
        + ", ".join(sorted({c.rsplit(".", 1)[0] if c.endswith(("float32",
                    "bfloat16")) else c for c in checked})))
    return {"checked": checked}


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


def time_flash_suffix(err: float) -> dict:
    """K1 at the prefix phase's suffix shape, ``shift = -p0`` over ``T =
    p0 + S0`` keys; the library yardstick is SDPA with the same mask as
    a boolean ``attn_mask``."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    p0, S0 = SUFFIX_SHAPES[0]
    B, H, Hkv, D, dt = 2, 16, 4, 64, torch.bfloat16
    T = p0 + S0
    q, k, v = _k1_inputs(B, H, Hkv, S0, D, dt, seed=101, T=T)
    scale = 1.0 / math.sqrt(D)

    def kernel():
        return A.flash_attention_shifted(q, k, v, -p0)

    shift = torch.tensor(-p0, dtype=torch.int32, device="cuda")

    def kernel_dev():
        return A.flash_attention_shifted(q, k, v, shift)

    ms, one = time_ms(kernel), time_ms(kernel, batch=1)
    # The two shift modes by CUDA events (the host's launching shows at
    # this size) and, in turns with the yardstick, by the profiler's
    # device time of every kernel of one call.
    dev_ms = time_ms(kernel_dev)
    kern = {"by_value": device_ms(kernel), "device": device_ms(kernel_dev)}
    plain = time_ms(lambda: A._reference_attention_lse(
        q, A.expand_kv(k, H), A.expand_kv(v, H), -p0, scale), reps=5,
        batch=1)
    mask = (torch.arange(T, device="cuda")[None, :]
            <= torch.arange(S0, device="cuda")[:, None] + p0)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)

    try:
        lib = time_ms(library)
    except TypeError:  # a PyTorch without enable_gqa: expanded K/V
        ke, ve = A.expand_kv(k, H), A.expand_kv(v, H)

        def library():
            return F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)

        lib = time_ms(library)
    kern["library"] = device_ms(library)
    kern["by_value_again"] = device_ms(kernel)
    kern["device_again"] = device_ms(kernel_dev)
    pairs = B * H * (S0 * p0 + S0 * (S0 + 1) / 2)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S0
    b_ms, b_by = bound(4 * D * pairs, nbytes, dt)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "horovod_tpu/ops/attention.py:124",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "tflops": tflops(4 * D * pairs, ms),
            "one_call_ms": one, "device_shift_ms": dev_ms,
            "kernel_device_ms": kern,
            "shape": f"B={B} H={H} H_kv={Hkv} S={S0} T={T} D={D} bf16 "
                     f"shift={-p0}"}


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


def time_paged(err: float, launches: int, R: int = 4) -> dict:
    """K4 at the serving shape, 8 slots x 2176 positions, with ``R``
    query rows a kv head: the decode tick's G = 4, or the speculative
    verify's G * W = 20 (its own kernels-line entry)."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import paged_attention as PA

    S, Hkv, Dh, ps, MP = 8, 4, 64, 16, 136
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
    return {"name": "paged_attend" if R == 4 else "paged_attend_verify",
            "route": "cuda",
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
    from horovod_tpu_torch.obs import xprof

    PEAK_FLOPS[torch.bfloat16] = xprof.PEAK_FLOPS_BY_KIND[H100]
    t_start = time.monotonic()
    card = card_info()
    with phase("build"):
        build()
        REPORT["sass_hmma"] = sass_check()
    with phase("kernel_checks"):
        k1 = check_flash()
        k23 = check_flash_bwd()
        k4 = check_paged()
    REPORT["kernel_checks"] = {"flash_fwd": k1, "flash_bwd": k23,
                               "paged_attend": k4}
    with phase("serving"):
        serving = serve_full_width(card)
    REPORT["serving_bf16"] = serving
    with phase("tracing"), tempfile.TemporaryDirectory(
            prefix="chip_smoke_tracing_") as tmp:
        traced = tracing_full_width(card, Path(tmp))
    REPORT["tracing"] = traced
    with phase("fleet"), tempfile.TemporaryDirectory(
            prefix="chip_smoke_fleet_") as tmp:
        fleet = fleet_full_width(card, Path(tmp), serving)
    REPORT["fleet"] = fleet
    with phase("token_identity_f32"):
        ident = token_identity()
    REPORT["token_identity_f32"] = ident
    with phase("fleet_f32"), tempfile.TemporaryDirectory(
            prefix="chip_smoke_fleet_f32_") as tmp:
        REPORT["fleet_f32"] = fleet_identity_f32(card, Path(tmp), F32_ORACLE)
    F32_ORACLE.clear()
    gc.collect()
    torch.cuda.empty_cache()
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
    with phase("speculative"):
        spec = spec_full_width(card)
    REPORT["speculative_bf16"] = spec
    with phase("collectives"):
        REPORT["collectives"] = collectives_size_one()
    with phase("model_grads_f32"):
        REPORT["model_grads_f32"] = model_grads_f32()
    with phase("training"):
        train = train_full_width()
    REPORT["train_bf16"] = train
    legs = train["legs"]
    log(f"training legs on {card} (median step ms / tok/s / MFU on useful "
        "FLOP / peak GB / device busy ms / idle share): " + "; ".join(
            f"{n} {lg['step_s_median'] * 1e3:.1f} / "
            f"{lg['tokens_per_s']:.0f} / {lg['mfu']:.4f} / "
            f"{lg['peak_mem_gb']:.2f} / "
            f"{lg['profile']['device_busy_ms']:.1f} / "
            f"{lg['profile']['idle_share']:.3f}" for n, lg in legs.items()))
    with phase("vision"):
        vision = vision_full_width(card)
    REPORT["vision"] = vision
    log(f"vision ResNet-50 legs (bf16, channels_last, 224², bench.py's "
        f"protocol; median img/s ±1.96σ / MFU / peak GB / captures / "
        f"replays) on {card}: " + "; ".join(
            f"{n} {lg['value']:.1f} ±{lg['stddev95']:.1f} / "
            f"{lg['mfu']:.4f} / {lg['peak_mem_bytes'] / 1e9:.2f} / "
            f"{lg['captures']} / {lg['replays']}"
            + (f" / device busy {lg['profile']['device_busy_ms']:.1f} ms of "
               f"{lg['profile']['wall_ms']:.1f}, idle share "
               f"{lg['profile']['idle_share']:.3f}" if "profile" in lg
               else "")
            for n, lg in vision["legs"].items()))
    # Each kernel's launches are the sum over the main paths' runs that
    # launch it: serving (the HTTP burst, the prefix run, the two SLO
    # legs, the speculative legs, the tracing phase's four bursts) and,
    # for K1-K3, the four training legs (K1 twice a layer a step in the
    # remat legs) and the tracing phase's traced training steps.
    served = [serving, serving["prefix"], *serving["slo"].values(),
              *spec["legs"].values(), *traced["legs"]]
    trained = {k: train["launches"][k] + traced["train"]["launches"][k]
               for k in train["launches"]}
    # The fleet's bursts, per replica process (its /stats counters): the
    # clean leg's two replicas and the SIGKILL leg's survivor.
    fleet_launches = {k: sum(d[f"{k}_launches"] for leg in ("clean", "sigkill")
                             for d in fleet[leg]["launches"].values())
                      for k in ("flash_fwd", "paged_attend")}
    k1_launches = sum(r["launches"]["flash_fwd"] for r in served) + \
        trained["flash_fwd"] + fleet_launches["flash_fwd"]
    verify_rows = FULL["n_heads"] // FULL["n_kv_heads"] * (SPEC_K + 1)
    k4_verify = sum(leg["launches"]["paged_attend_by_rows"].get(
        verify_rows, 0) for leg in spec["legs"].values())
    k4_launches = sum(r["launches"]["paged_attend"] for r in served) \
        - k4_verify + fleet_launches["paged_attend"]
    t_times = time.monotonic()
    kernels = [time_flash(k1["serving"], k1_launches),
               *time_flash_bwd(k23["training"], trained),
               time_paged(k4["serving"], k4_launches),
               time_paged(k4["verify"], k4_verify, R=verify_rows)]
    k1_train = time_flash(None, train["launches"]["flash_fwd"],
                          B=TRAIN_BATCH, Hkv=16)
    REPORT["flash_fwd_training_shape"] = k1_train
    k1_suffix = time_flash_suffix(k1["suffix"])
    REPORT["flash_fwd_suffix_shape"] = k1_suffix
    REPORT["phase_s"]["times"] = time.monotonic() - t_times
    log(f"phase times: {REPORT['phase_s']['times']:.1f} s")
    log(f"flash_fwd device shift [{k1_suffix['shape']}]: "
        f"{k1_suffix['device_shift_ms']:.4f} ms against "
        f"{k1_suffix['ms']:.4f} ms by value (CUDA events, 10 calls); "
        f"kernel device time (profiler, in turns) "
        f"{k1_suffix['kernel_device_ms']}")
    k4r4, k4r20 = kernels[-2], kernels[-1]
    log(f"K4 at the verify's R = {verify_rows} on {card}: "
        f"{k4r20['ms']:.4f} ms device time beside {k4r4['ms']:.4f} ms at "
        f"R = 4; byte bound {k4r20['bound_ms']:.4f} ms ({k4r20['bound_by']}"
        f"); SDPA over gathered K/V at R = {verify_rows} "
        f"{k4r20['library_ms']:.4f} ms; {k4_verify} verify launches in the "
        "speculative legs")
    for kr in kernels + [k1_train, k1_suffix]:
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
