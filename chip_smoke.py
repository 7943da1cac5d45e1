#!/usr/bin/env python3
"""Drive horovod_tpu_torch's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Card: the card's name and power limit, as ``nvidia-smi`` reports them.
2. Build: every kernel under ``horovod_tpu_torch/ops/csrc/``, one
   ``nvcc`` per source, all started together.
3. Kernels against their plain PyTorch versions on the card, at the
   serving path's shapes, each maximum error printed beside its
   tolerance: flash attention forward (K1) in bf16 and f32, head_dim 64
   and 128, causal, S from 8 to 2048; paged-attention decode (K4) over
   f32, bf16 and int8 pools with an edge table (partial last page, a
   slot at table capacity, a ``limit = 0`` slot, a page shared by two
   slots).
4. Serving at full width: ``InferenceEngine`` + ``ServingServer`` on
   the d1024/L8/H16/kv4 bf16 Transformer from ``init_params`` seed 0;
   8 concurrent ``POST /generate`` requests whose prompts cover the
   buckets 8..2048.  Every request must return its full token count and
   both kernels' launch counters must grow during the run.
5. Token identity: the same configuration in f32 (TF32 off for matmuls
   and cuDNN) against the per-request ``greedy_decode`` oracle.  A
   mismatch is exempt only at or after a position where the oracle's
   top-2 logit margin is below ``NEAR_TIE``; every exemption is printed.
6. Times: each kernel at the serving shape (CUDA events, median of
   repeats) beside its bound, its plain version and a PyTorch yardstick
   the port never calls; the serving run's decode tok/s, TTFT and
   per-tick time.

A ``report:`` line carries every measurement as JSON; the line before
last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
NEAR_TIE = 1e-3  # f32 top-2 logit margin under which the pick is a tie

FULL = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
            n_kv_heads=4, d_ff=4096, max_seq=2176, attention_impl="flash")
ENGINE = dict(n_slots=8, max_len=2176, max_prefills_per_tick=2,
              page_size=16, max_queue_depth=64, default_max_new_tokens=128)
PROMPT_LENS = [5, 16, 40, 100, 300, 700, 1500, 2048]
NEW_TOKENS = [128, 64, 96, 128, 80, 112, 64, 128]
F32_NEW_TOKENS = 32
PROFILE_DEPTH = 1000  # every slot's prompt length in the profiled ticks

REPORT: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of one call, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"


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


# --- phase 3: kernels against their plain versions ---------------------------


def _k1_inputs(B, H, Hkv, S, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    return r(B, H, S, D), r(B, Hkv, S, D), r(B, Hkv, S, D)


def check_flash() -> dict:
    from horovod_tpu_torch.ops import attention as A

    worst = {}
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    cases = [(dt, D, S, True) for dt in (torch.bfloat16, torch.float32)
             for D in (64, 128) for S in (8, 100, 2048)]
    cases += [(dt, 64, 256, False) for dt in (torch.bfloat16, torch.float32)]
    for i, (dt, D, S, causal) in enumerate(cases):
        B, H, Hkv = 2, 16, 4
        q, k, v = _k1_inputs(B, H, Hkv, S, D, dt, seed=i)
        o, lse = A.flash_attention_lse(q, k, v, causal)
        o_r, l_r = A._reference_attention_lse(
            q, A.expand_kv(k, H), A.expand_kv(v, H), 0 if causal else None,
            1.0 / math.sqrt(D))
        torch.cuda.synchronize()
        err = max((o.float() - o_r.float()).abs().max().item(),
                  (lse - l_r).abs().max().item())
        name = (f"K1 {str(dt)[6:]} D={D} S={S} "
                f"{'causal' if causal else 'full'}")
        log(f"{name}: max_abs_err={err:.3e} tol={tol[dt]:.0e}")
        if not err <= tol[dt]:
            raise AssertionError(f"{name} disagrees with its plain version")
        if dt == torch.bfloat16 and D == 64 and S == 2048 and causal:
            worst["serving"] = err
        worst[name] = err
    return worst


def _k4_case(kind, compute, Dh=64, S=8, Hkv=4, R=4, ps=16, MP=136,
             P=1089, seed=0):
    from horovod_tpu_torch.models import transformer as T

    g = torch.Generator(device="cuda").manual_seed(seed)
    qg = torch.randn((S, Hkv, R, Dh), generator=g, device="cuda")
    kf = torch.randn((P, Hkv, ps, Dh), generator=g, device="cuda")
    vf = torch.randn((P, Hkv, ps, Dh), generator=g, device="cuda")
    table = torch.randint(1, P, (S, MP), generator=g, device="cuda",
                          dtype=torch.int32)
    table[1] = table[0]                       # a page shared by two slots
    lim = [ps * MP, 5, 0, ps + 3, 1000, 1, 2048, 777][:S]
    limit = torch.tensor(lim, dtype=torch.int32, device="cuda")
    if kind == "int8":
        kq, ks = T.kv_quantize(kf)
        vq, vs = T.kv_quantize(vf)
        args = (qg.to(compute), kq, vq, ks, vs)
    else:
        args = (qg.to(kind), kf.to(kind), vf.to(kind), None, None)
    return args, table, limit


def check_paged() -> dict:
    from horovod_tpu_torch.ops import paged_attention as PA

    worst = {}
    cases = [(torch.float32, torch.float32, 64, 1e-4),
             (torch.bfloat16, torch.bfloat16, 64, 2e-2),
             ("int8", torch.bfloat16, 64, 2e-2),
             ("int8", torch.float32, 64, 1e-4),
             (torch.bfloat16, torch.bfloat16, 128, 2e-2)]
    for i, (kind, compute, Dh, tol) in enumerate(cases):
        args, table, limit = _k4_case(kind, compute, Dh=Dh, seed=i)
        o, lse = PA.paged_attend(*args, table, limit, compute_dtype=compute)
        o_r, l_r = PA.paged_attend_reference(*args, table, limit,
                                             compute_dtype=compute)
        torch.cuda.synchronize()
        live = limit > 0
        err = max((o - o_r).abs().max().item(),
                  (lse[live] - l_r[live]).abs().max().item())
        name = f"K4 pool={str(kind).replace('torch.', '')} " \
               f"compute={str(compute)[6:]} Dh={Dh}"
        log(f"{name}: max_abs_err={err:.3e} tol={tol:.0e}")
        if not err <= tol:
            raise AssertionError(f"{name} disagrees with its plain version")
        if o[~live].abs().max().item() != 0 or \
                not (lse[~live] <= PA.NEG_INF / 2).all():
            raise AssertionError(f"{name}: a limit=0 slot is not (0, NEG_INF)")
        if kind == torch.bfloat16 and Dh == 64:
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


def profile_decode(engine, n_ticks: int = 8) -> dict:
    """Where a steady decode tick's time goes: every slot busy at depth
    ``PROFILE_DEPTH``; ``n_ticks`` synchronous ticks timed by the host
    clock, then ``n_ticks`` more under ``torch.profiler`` for the device
    time by kernel (the profiler's own host cost stays out of the
    wall time)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(2)
    futs = [engine.submit(rng.integers(0, FULL["vocab_size"],
                                       PROFILE_DEPTH).tolist(),
                          max_new_tokens=2 * n_ticks + 8)
            for _ in range(ENGINE["n_slots"])]
    while engine.scheduler.depth:
        engine.step()
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n_ticks):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / n_ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            engine.step()
        torch.cuda.synchronize()
    while not all(f.done() for f in futs):
        engine.step()
    kernels, launches = {}, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0 and not e.key.startswith("aten::"):  # device kernels only
            kernels[e.key] = t / 1e3 / n_ticks          # ms per tick
            launches += e.count
    busy = sum(kernels.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    k4 = sum(t for k, t in kernels.items() if "paged_attend_kernel" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out = {"ticks": n_ticks, "tick_wall_ms": wall_ms,
           "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
           "paged_attend_ms": k4, "paged_attend_share_of_busy": k4 / busy,
           "kernels_launched_per_tick": launches / n_ticks,
           "top_kernels_ms": {k[:70]: t for k, t in top}}
    log(f"decode tick profile (8 slots at depth {PROFILE_DEPTH}): wall "
        f"{wall_ms:.3f} ms, device busy {busy:.3f} ms (idle share "
        f"{out['idle_share']:.3f}), paged_attend {k4:.3f} ms, "
        f"{out['kernels_launched_per_tick']:.0f} kernels per tick")
    return out


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
    engine = InferenceEngine(params, cfg, EngineConfig(**ENGINE))
    engine.warmup((8,))
    profile = profile_decode(engine)
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
                                 "max_new_tokens": NEW_TOKENS[i]})

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
    ticks = stats["decode_ticks"] - ticks0
    tick_s = sum(stats[f"{k}_seconds"]["sum"] - sums0[k] for k in sums0)
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    total = sum(NEW_TOKENS)
    out = {
        "params": n_params, "requests": len(prompts),
        "prompt_lens": PROMPT_LENS, "new_tokens": NEW_TOKENS,
        "wall_s": wall, "tokens": total, "tok_per_s": total / wall,
        "decode_ticks": ticks, "tick_ms_mean": tick_s / ticks * 1e3,
        "ttft_ms_p50": statistics.median(ttft), "ttft_ms_max": ttft[-1],
        "launches": launches,
        "kv_pages_high_water": stats["kv_pages_high_water"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "decode_profile": profile,
    }
    log(f"serving bf16: {len(prompts)} requests, {total} tokens in "
        f"{wall:.3f} s = {out['tok_per_s']:.1f} tok/s; {ticks} decode "
        f"ticks at {out['tick_ms_mean']:.3f} ms; TTFT p50 "
        f"{out['ttft_ms_p50']:.1f} ms max {out['ttft_ms_max']:.1f} ms; "
        f"launches {launches}")
    del engine, params
    torch.cuda.empty_cache()
    return out


def token_identity() -> dict:
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serving import EngineConfig, InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = T.TransformerConfig(**FULL, dtype=torch.float32)
    params = T.init_params(cfg, seed=0)
    engine = InferenceEngine(params, cfg, EngineConfig(**ENGINE))
    prompts = _prompts(seed=1)
    futs = [engine.submit(p, max_new_tokens=F32_NEW_TOKENS) for p in prompts]
    while not all(f.done() for f in futs):
        engine.step()
    exempt = []
    for i, (p, f) in enumerate(zip(prompts, futs)):
        got = f.result(timeout=0)
        ref, gap = T.greedy_decode(params, torch.tensor([p], device="cuda"),
                                   F32_NEW_TOKENS, cfg, margins=True)
        ref, gap = ref[0].tolist(), gap[0].tolist()
        if got == ref:
            continue
        first = next(j for j in range(len(ref)) if got[j] != ref[j])
        ties = [j for j in range(first + 1) if gap[j] < NEAR_TIE]
        if not ties:
            raise AssertionError(
                f"f32 request {i} (prompt {len(p)}) diverges from the "
                f"oracle at token {first} with margin {gap[first]:.3e}")
        exempt.append({"request": i, "prompt_len": len(p),
                       "first_mismatch": first, "tie_at": ties[0],
                       "margin": gap[ties[0]]})
        log(f"exemption: f32 request {i} diverges at token {first} after "
            f"a near-tie at token {ties[0]} (margin {gap[ties[0]]:.3e} < "
            f"{NEAR_TIE})")
    log(f"token identity f32: {len(prompts)} requests x {F32_NEW_TOKENS} "
        f"tokens, {len(exempt)} near-tie exemptions (TF32 off)")
    del engine, params
    torch.cuda.empty_cache()
    return {"requests": len(prompts), "exemptions": exempt}


# --- phase 6: times ----------------------------------------------------------


def time_flash(err: float, launches: int) -> dict:
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    B, H, Hkv, S, D, dt = 2, 16, 4, 2048, 64, torch.bfloat16
    q, k, v = _k1_inputs(B, H, Hkv, S, D, dt, seed=100)
    ke, ve = A.expand_kv(k, H), A.expand_kv(v, H)
    scale = 1.0 / math.sqrt(D)
    ms = time_ms(lambda: A.flash_attention_lse(q, k, v, True))
    plain = time_ms(lambda: A._reference_attention_lse(
        q, A.expand_kv(k, H), A.expand_kv(v, H), 0, scale), reps=5)
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
            "library_ms": lib,
            "shape": f"B={B} H={H} H_kv={Hkv} S=T={S} D={D} bf16 causal"}


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
    ms = time_ms(lambda: PA.paged_attend(qg, kp, vp, None, None, table,
                                         limit))
    plain = time_ms(lambda: PA.paged_attend_reference(
        qg, kp, vp, None, None, table, limit), reps=10)
    kg = T._gather_pages(kp, table)
    vg = T._gather_pages(vp, table)
    vis = (torch.arange(MP * ps, device="cuda")[None, :]
           < limit[:, None])[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=vis))
    n_pos = int(limit.sum())
    kv_bytes = 2 * n_pos * Hkv * Dh * kp.element_size()
    nbytes = (kv_bytes + qg.numel() * qg.element_size() + table.numel() * 4
              + S * 4 + S * Hkv * R * Dh * 4 + S * Hkv * R * 4)
    b_ms, b_by = bound(4 * Hkv * R * Dh * n_pos, nbytes, torch.bfloat16)
    return {"name": "paged_attend", "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "horovod_tpu/ops/paged_attention.py:101",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib,
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
    k1 = check_flash()
    k4 = check_paged()
    REPORT["kernel_checks"] = {"flash_fwd": k1, "paged_attend": k4}
    serving = serve_full_width()
    REPORT["serving_bf16"] = serving
    REPORT["token_identity_f32"] = token_identity()
    kernels = [time_flash(k1["serving"], serving["launches"]["flash_fwd"]),
               time_paged(k4["serving"],
                          serving["launches"]["paged_attend"])]
    for kr in kernels:
        log(f"{kr['name']} [{kr['shape']}]: {kr['ms']:.4f} ms, bound "
            f"{kr['bound_ms']:.4f} ms ({kr['bound_by']}), plain "
            f"{kr['plain_ms']:.4f} ms, library {kr['library_ms']:.4f} ms")
    REPORT["kernels"] = kernels
    REPORT["seconds"] = time.monotonic() - t_start
    log("report: " + json.dumps(REPORT, default=str))
    log(f"card: {card}")
    print(json.dumps({"kernels": [
        {k: v for k, v in kr.items() if k != "shape"} for kr in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
