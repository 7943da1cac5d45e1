"""horovod_tpu_torch's CUDA kernels against their plain versions, on the
card.  Every test here is marked ``cuda`` and skips without a CUDA
device: the kernels have no CPU mode.  The file imports no JAX, so it
also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: f32 1e-4 (summation order); bf16 5e-2 for flash attention
(the plain version rounds the scores to bf16, the kernel keeps them in
f32) and 2e-2 for bf16 paged pools (weights cast to bf16 before versus
after normalizing).  The flash backward (K2, K3) is held to its plain
version relative to the largest gradient: 1e-4 at f32 (summation
order), 2e-2 at bf16 (p, ds and the outputs are rounded to bf16, whose
step is 2^-8 = 3.9e-3 of a value: a few one-step flips where the f32
sums differ in their last bits).  The serving engine's decode tick,
captured as a CUDA graph, is held to the same tick run eagerly bit for
bit: the same kernels on the same inputs.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch import serving
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import attention as A
from horovod_tpu_torch.ops import paged_attention as PA

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _shift(mask, S, T):
    """Mask names as the kernels' shift (col + shift <= row attends)."""
    return {"causal": 0, "full": None, "shift67": 67, "bottom_right": S - T,
            "none_visible": T - S}[mask]


# (S, T, mask): the edge shapes of the tensor-core tiles (64 rows): ragged
# S, and S != T unmasked, bottom-right causal and with every row masked.
EDGE_CASES = ([(S, S, "causal") for S in (1, 17, 63, 65, 2047)]
              + [(100, 300, m) for m in ("full", "bottom_right",
                                         "none_visible")])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,T,mask", [(200, 200, "causal")] + EDGE_CASES)
def test_flash_kernel(dev, dtype, tol, D, S, T, mask):
    """K1 against its plain version, GQA G = 4."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, 8, S, D), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, 2, T, D), generator=g, device=dev).to(dtype)
            for _ in range(2))
    shift = _shift(mask, S, T)
    before = A.flash_fwd_launches
    if shift is None:
        o, lse = A.flash_attention_with_lse(q, k, v, False)
    else:
        o, lse = A.flash_attention_shifted(q, k, v, shift)
    assert A.flash_fwd_launches == before + 1
    o_r, l_r = A._reference_attention_lse(
        q, A.expand_kv(k, 8), A.expand_kv(v, 8), shift, 1 / D ** 0.5)
    assert (o.float() - o_r.float()).abs().max().item() <= tol
    assert (lse - l_r).abs().max().item() <= tol


def _rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1.0)).item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Hkv", [8, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("S,T,mask", [(200, 200, m) for m in (
    "causal", "full", "shift67")] + EDGE_CASES)
def test_flash_backward_kernels(dev, dtype, tol, D, Hkv, S, T, mask):
    """K2 and K3 through the autograd Function, with a nonzero lse
    cotangent, against the plain backward on the same forward results
    (shift 67 leaves rows 0..66 fully masked)."""
    g = torch.Generator(device=dev).manual_seed(1)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, k, v = r(2, 8, S, D), r(2, Hkv, T, D), r(2, Hkv, T, D)
    do, dlse = r(2, 8, S, D), r(2, 8, S).float()
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    shift = _shift(mask, S, T)
    scale = D ** -0.5
    n2, n3 = A.flash_bwd_dkdv_launches, A.flash_bwd_dq_launches
    o, lse = A._FlashAttention.apply(q, k, v, shift, scale)
    grads = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
    assert (A.flash_bwd_dkdv_launches, A.flash_bwd_dq_launches) == (
        n2 + 1, n3 + 1)
    delta = (do.float() * o.float()).sum(-1) - dlse
    want = A._flash_bwd_reference(q.detach(), k.detach(), v.detach(), do,
                                  lse.detach(), delta, shift, scale)
    for got, ref in zip(grads, want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert _rel_err(got, ref) <= tol


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, "_mma"), (torch.float32, "")])
def test_each_dtype_reaches_its_instantiation(dev, dtype, kernel):
    """bf16 runs the tensor-core K1, K2 and K3 (``*_kernel_mma``), f32
    the scalar ones: the profiler names the kernels each call launched,
    the launch counters grow by one each, and the results match the
    plain versions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (torch.randn((1, 4, 96, 64), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (A.flash_fwd_launches, A.flash_bwd_dkdv_launches,
              A.flash_bwd_dq_launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o = A.flash_attention(q, k, v, True)
        grads = torch.autograd.grad(o, (q, k, v), do)
        torch.cuda.synchronize()
    assert (A.flash_fwd_launches, A.flash_bwd_dkdv_launches,
            A.flash_bwd_dq_launches) == tuple(n + 1 for n in before)
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    for base in ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                 "flash_bwd_dq_kernel"):
        ran = [n for n in names if base in n]
        assert ran and all(("_mma" in n) == bool(kernel) for n in ran), names
    scale = 64 ** -0.5
    o_r, lse_r = A._reference_attention_lse(q.detach(), k.detach(),
                                            v.detach(), 0, scale)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert (o.float() - o_r.float()).abs().max().item() <= tol
    _, lse = A.flash_attention_with_lse(q.detach(), k.detach(), v.detach(),
                                        True)
    delta = (do.float() * o.detach().float()).sum(-1)
    want = A._flash_bwd_reference(q.detach(), k.detach(), v.detach(), do,
                                  lse, delta, 0, scale)
    for got, ref in zip(grads, want):
        assert _rel_err(got, ref) <= (2e-2 if dtype == torch.bfloat16
                                      else 1e-4)


def _edge_case(kv, dev):
    """Partial last page, a slot at table capacity, a limit=0 slot, two
    slots sharing pages, and the split edges: 8 slots x 4 kv heads x 40
    pages run 3 pages (48 positions) a split, so limits 48 and 96 end on
    a split boundary, 49 one position past it, 47 one short, and every
    slot but the full ones has splits wholly past its limit."""
    rng = np.random.RandomState(3)
    S, Hkv, G, Dh, ps, MP, Pn = 8, 4, 2, 64, 16, 40, 200
    assert PA.split_grid(S, Hkv, G, MP)[0] == 3
    qg = torch.from_numpy(rng.randn(S, Hkv, G, Dh).astype(np.float32))
    kf = torch.from_numpy(rng.randn(Pn, Hkv, ps, Dh).astype(np.float32))
    vf = torch.from_numpy(rng.randn(Pn, Hkv, ps, Dh).astype(np.float32))
    table = np.asarray(rng.randint(1, Pn, (S, MP)), np.int32)
    table[1] = table[0]
    limit = np.asarray([ps * MP, 5, 0, ps + 3, 48, 49, 47, 96], np.int32)
    if kv == "int8":
        (kq, ks), (vq, vs) = T.kv_quantize(kf), T.kv_quantize(vf)
        args = (qg, kq, vq, ks, vs)
    else:
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        args = (qg, kf.to(dt), vf.to(dt), None, None)
    args = [a.to(dev) if a is not None else None for a in args]
    return (args, torch.from_numpy(table).to(dev),
            torch.from_numpy(limit).to(dev))


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_paged_kernel(dev, kv):
    """K4 against its plain version on the edge table; a second call
    gives the same bits (no atomics, splits combined in order)."""
    args, table, limit = _edge_case(kv, dev)
    before = PA.paged_attend_launches
    o, lse = PA.paged_attend(*args, table, limit,
                             compute_dtype=torch.float32)
    assert PA.paged_attend_launches == before + 1
    o2, lse2 = PA.paged_attend(*args, table, limit,
                               compute_dtype=torch.float32)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_r, l_r = PA.paged_attend_reference(*args, table, limit,
                                         compute_dtype=torch.float32)
    tol = 2e-2 if kv == "bf16" else 1e-4
    live = limit > 0
    assert (o - o_r).abs().max().item() <= tol
    assert (lse[live] - l_r[live]).abs().max().item() <= tol
    assert not o[~live].any() and (lse[~live] <= PA.NEG_INF / 2).all()


def test_flash_gradient_runs_the_kernels(dev):
    """A CUDA input that requires grad trains through K1-K3 (slice 1
    refused it): f32 gradients of a GQA causal call equal autograd
    through the plain attention."""
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((1, 4, 130, 64), generator=g, device=dev)
    k, v = (torch.randn((1, 2, 130, 64), generator=g, device=dev)
            for _ in range(2))
    w = torch.randn((1, 4, 130, 64), generator=g, device=dev)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    launches = (A.flash_fwd_launches, A.flash_bwd_dkdv_launches,
                A.flash_bwd_dq_launches)
    (A.flash_attention(*ins, True) * w).sum().backward()
    assert (A.flash_fwd_launches, A.flash_bwd_dkdv_launches,
            A.flash_bwd_dq_launches) == tuple(n + 1 for n in launches)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    (A.reference_attention(ref[0], A.expand_kv(ref[1], 4),
                           A.expand_kv(ref[2], 4), causal=True) * w
     ).sum().backward()
    for a, b in zip(ins, ref):
        assert _rel_err(a.grad, b.grad) <= 1e-4


def test_cuda_input_never_falls_back(dev):
    q = torch.zeros((1, 2, 8, 48), device=dev)  # head_dim 48: no kernel
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_attention(q, q, q, True)
    x = torch.zeros((1, 2, 8, 64), device=dev)
    with pytest.raises(TypeError, match="one dtype"):
        A.flash_attention(x, x.double(), x, True)
    with pytest.raises(TypeError, match="int32"):
        PA.paged_attend(torch.zeros((1, 1, 1, 64), device=dev),
                        x[0, :1, None], x[0, :1, None], None, None,
                        torch.zeros((1, 1), dtype=torch.int64, device=dev),
                        torch.ones(1, dtype=torch.int32, device=dev))
    # K4's 16-byte vector loads cut a head dim only in multiples of 8.
    p20 = torch.zeros((2, 1, 16, 20), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        PA.paged_attend(torch.zeros((1, 1, 1, 20), device=dev), p20, p20,
                        None, None,
                        torch.ones((1, 1), dtype=torch.int32, device=dev),
                        torch.ones(1, dtype=torch.int32, device=dev))


# The serving width (chip_smoke.py's FULL), cut to 512 positions a slot.
SERVE = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
             n_kv_heads=4, d_ff=4096, max_seq=512, attention_impl="flash")
# Half greedy, half sampled, every sampling option.
SAMPLING = [{}, dict(temperature=1.0, seed=1), {},
            dict(temperature=0.8, top_k=40, seed=2), {},
            dict(temperature=1.2, top_p=0.9, seed=3), {},
            dict(temperature=0.7, top_k=100, top_p=0.95, seed=4)]


def _serving_engine(dev, **kw):
    cfg = T.TransformerConfig(**SERVE, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0, device=dev)
    ec = serving.EngineConfig(n_slots=8, max_len=512, page_size=16, **kw)
    return serving.InferenceEngine(params, cfg, ec, device=dev), cfg


def _mixed_requests(engine, new_tokens):
    rng = np.random.default_rng(5)
    return [engine.submit(rng.integers(0, 32000, n).tolist(),
                          max_new_tokens=new_tokens, **kw)
            for n, kw in zip((5, 40, 100, 17, 300, 64, 9, 200), SAMPLING)]


def test_captured_tick_bit_identical_to_eager(dev):
    """Twenty ticks of a live mix (greedy and sampled slots at unequal
    depths crossing page boundaries, one slot leaving halfway): the
    replayed graph's tokens, max logits, pool bytes and positions equal
    the eager tick's, run from a copy of the same state; K4 launches
    once a layer a replay."""
    engine, cfg = _serving_engine(dev, overlap=False)
    engine.warmup((8,))
    assert engine.stats()["decode_compilations"] == 1
    futs = _mixed_requests(engine, 60)
    while engine.scheduler.depth or engine.slots.active_count < 8:
        engine.step()
    engine.step()
    # Pages for the next 20 positions of every slot, then the inputs.
    ps = engine.slots.page_size
    for s in range(8):
        p0 = int(engine._page_pos[s])
        for idx in range(p0 // ps, (p0 + 20) // ps + 1):
            if engine.slots.table[s, idx] == serving.NULL_PAGE:
                engine.slots.grant(s, idx)
    tick = engine._tick
    tick.table.copy_(torch.from_numpy(engine.slots.table))
    tick.tokens.copy_(torch.from_numpy(engine._host_tokens()))
    tick.active.fill_(True)
    engine._samp.device()
    eager = tick.twin()
    k4, replays = PA.paged_attend_launches, tick.replays
    graphed = []
    for i in range(20):
        if i == 10:
            tick.active[3] = False
        nxt, mx = tick.run()
        graphed.append((nxt.clone(), mx.clone()))
    assert tick.replays - replays == 20
    assert PA.paged_attend_launches - k4 == 20 * cfg.n_layers
    for i in range(20):
        if i == 10:
            eager.active[3] = False
        nxt, mx = eager.body()
        assert torch.equal(nxt, graphed[i][0]), i
        assert torch.equal(mx, graphed[i][1]), i
    for name, t in tick.pool.items():
        assert torch.equal(t, eager.pool[name]), name
    assert engine.stats()["decode_compilations"] == 1
    engine.terminate()


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_one_capture_across_a_mixed_burst(dev, overlap):
    """decode_compilations is 1 after warmup and after a burst of greedy
    and sampled requests (parameters are data); K4's launch count grows
    by replays x layers; every request returns its full count."""
    engine, cfg = _serving_engine(dev, overlap=overlap)
    engine.warmup((8,))
    assert engine.stats()["decode_compilations"] == 1
    k4, replays = PA.paged_attend_launches, engine._tick.replays
    futs = _mixed_requests(engine, 24)
    while not all(f.done() for f in futs):
        engine.step()
    assert all(len(f.result(timeout=0)) == 24 for f in futs)
    st = engine.stats()
    assert st["decode_compilations"] == 1
    n = engine._tick.replays - replays
    assert n >= 23 and PA.paged_attend_launches - k4 == n * cfg.n_layers


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_restart_resets_in_place_and_keeps_the_capture(dev, overlap):
    """A decode fault mid-burst restarts the engine: the pool and the
    tick's inputs are zeroed where they lie (the same tensors the graph
    captured), the graph is replayed and not recaptured, and every
    request resumes to its full count."""
    inj = serving.FaultInjector()
    engine, cfg = _serving_engine(dev, overlap=overlap, faults=inj)
    engine.warmup((8,))
    futs = _mixed_requests(engine, 24)
    while sum(len(f.tokens_so_far()) for f in futs) < 60:
        engine.step()
    ptrs = {k: t.data_ptr() for k, t in engine.slots.cache.items()}
    replays = engine._tick.replays
    inj.add(serving.FaultSpec(site="decode_tick", kind="raise",
                              skip=inj.visits("decode_tick")))
    while not all(f.done() for f in futs):
        engine.step()
    assert all(len(f.result(timeout=0)) == 24 for f in futs)
    st = engine.stats()
    assert (st["engine_restarts"], st["decode_compilations"],
            st["journal_inflight"], st["state"]) == (1, 1, 0, "healthy")
    assert st["requests_resumed"] >= 1
    assert engine._tick.pool is engine.slots.cache
    assert {k: t.data_ptr() for k, t in engine.slots.cache.items()} == ptrs
    assert engine._tick.replays > replays
