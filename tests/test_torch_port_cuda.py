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
bit: the same kernels on the same inputs, also after a copy-on-write of
a shared prefix page; so is each admission graph (a whole-prompt
prefill, a suffix prefill replayed at two prefix lengths, a chunk, the
first-token sampler) against its body run eagerly, and K1 reading its
shift from the device against K1 given it by value.  The captured train
step (one graph; two at ``backward_passes_per_step=2``) is held to its
eager body bit for bit at f32, and every collective runs on CUDA tensors
in a size-1 NCCL group.  The vision path: the bench's captured ResNet
step against its eager body bit for bit under ``cudnn.deterministic``,
the loader's prefetched batches against the host rows (``record_stream``
held to its purpose), and ``xprof``'s ResNet-50 FLOP count within 10 %
of the analytic one.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch import serving
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import attention as A
from horovod_tpu_torch.ops import paged_attention as PA
from horovod_tpu_torch.serving.cache import copy_page, pad_pages
from horovod_tpu_torch.serving.graph import PrefillGraphs

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


# (p0, S0): K1 as prefill_with_prefix calls it, shift = -p0 over T = p0 +
# S0 keys — prefixes on and off a page or key block, chunk shapes.
SUFFIX_CASES = [(15, 16), (32, 32), (1000, 256), (2016, 32), (1024, 512)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("p0,S0", SUFFIX_CASES)
def test_flash_kernel_suffix_shift(dev, dtype, tol, p0, S0):
    """K1 at a suffix's shapes (negative shift, T != S, GQA G = 4)
    against its plain version."""
    g = torch.Generator(device=dev).manual_seed(p0)
    q = torch.randn((2, 8, S0, 64), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, 2, p0 + S0, 64), generator=g,
                        device=dev).to(dtype) for _ in range(2))
    o, lse = A.flash_attention_shifted(q, k, v, -p0)
    o_r, l_r = A._reference_attention_lse(
        q, A.expand_kv(k, 8), A.expand_kv(v, 8), -p0, 1 / 64 ** 0.5)
    assert (o.float() - o_r.float()).abs().max().item() <= tol
    assert (lse - l_r).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p0,S0", SUFFIX_CASES)
def test_flash_kernel_device_shift(dev, dtype, p0, S0):
    """K1 reading ``shift = -p0`` from device memory (the captured
    suffix prefills' mode) equals K1 given it by value, bit for bit,
    over a key buffer with junk past ``p0 + S0``."""
    g = torch.Generator(device=dev).manual_seed(p0 + 1)
    q = torch.randn((2, 8, S0, 64), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, 2, p0 + S0 + 48, 64), generator=g,
                        device=dev).to(dtype) for _ in range(2))
    before = A.flash_fwd_launches
    by_value = A.flash_attention_shifted(q, k, v, -p0)
    shift = torch.tensor(-p0, dtype=torch.int32, device=dev)
    from_device = A.flash_attention_shifted(q, k, v, shift)
    assert A.flash_fwd_launches == before + 2
    for a, b in zip(by_value, from_device):
        assert torch.equal(a, b)


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


def test_cow_keeps_the_capture_and_equals_the_eager_tick(dev):
    """Slots attached to a registered prefix whose last page is partial:
    their first decode write copies that page (in place, inside the pool
    tensors the graph captured).  Twenty replays after the copy equal
    twenty eager ticks run from a copy of the same state, bit for bit;
    the pool keeps its addresses and the graph is not recaptured.  Then
    a burst of sharers through ``step()`` returns every token."""
    engine, cfg = _serving_engine(dev, overlap=False)
    engine.warmup((8,))
    ptrs = {k: t.data_ptr() for k, t in engine.slots.cache.items()}
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, 32000, 75).tolist()  # 4 pages and 11 tokens
    engine.register_prefix(prefix)
    entry = engine._prefixes[tuple(prefix)]
    futs = [engine.submit(list(prefix) if i % 2 else
                          prefix + rng.integers(0, 32000, 9 + i).tolist(),
                          max_new_tokens=40, **kw)
            for i, kw in enumerate(SAMPLING)]
    while engine.scheduler.depth or engine.slots.active_count < 8:
        engine._admit_pending()  # land, no decode: nothing copied yet
    shared = entry.pages[-1]
    assert engine.slots._ref[shared] > 2
    tick = engine._tick
    tick.table.copy_(torch.from_numpy(engine.slots.table))
    tick.tokens.copy_(torch.from_numpy(engine._host_tokens()))
    tick.active.fill_(True)
    engine._samp.device()
    eager = tick.twin()
    # The copies: every attach-only slot's write page is the shared one.
    ps = engine.slots.page_size
    before = engine.slots.table.copy()
    for s in range(8):
        for idx in range(int(engine._page_pos[s]) // ps,
                         (int(engine._page_pos[s]) + 20) // ps + 1):
            engine._claim_page(s, idx, lambda: True)
    moved = [(int(before[s, i]), int(engine.slots.table[s, i]))
             for s, i in zip(*np.nonzero(before != engine.slots.table))
             if before[s, i] != serving.NULL_PAGE]
    assert len(moved) == 4 and all(src == shared for src, _ in moved)
    for src, dst in moved:
        copy_page(eager.pool, src, dst)
    tick.table.copy_(torch.from_numpy(engine.slots.table))
    eager.table.copy_(tick.table)
    graphed = [tuple(t.clone() for t in tick.run()) for _ in range(20)]
    for i in range(20):
        nxt, mx = eager.body()
        assert torch.equal(nxt, graphed[i][0]), i
        assert torch.equal(mx, graphed[i][1]), i
    for name, t in tick.pool.items():
        assert torch.equal(t, eager.pool[name]), name
    assert {k: t.data_ptr() for k, t in engine.slots.cache.items()} == ptrs
    assert engine.stats()["decode_compilations"] == 1
    engine.terminate()
    # The same mix through the engine, copies and all.
    engine, cfg = _serving_engine(dev)
    engine.warmup((8,))
    ptrs = {k: t.data_ptr() for k, t in engine.slots.cache.items()}
    engine.register_prefix(prefix)
    futs = [engine.submit(list(prefix) if i % 2 else prefix + [i + 1] * 5,
                          max_new_tokens=24, **kw)
            for i, kw in enumerate(SAMPLING)]
    shared_seen = 0
    while not all(f.done() for f in futs):
        engine.step()
        shared_seen = max(shared_seen, engine.slots.pages_shared)
    assert all(len(f.result(timeout=0)) == 24 for f in futs)
    assert shared_seen >= 4
    assert engine.stats()["decode_compilations"] == 1
    assert {k: t.data_ptr() for k, t in engine.slots.cache.items()} == ptrs


# --- the admission graphs ----------------------------------------------------


def _graph_equals_body(graphs, key, fields, logits=None):
    """Replay ``key`` with ``fields`` on ``graphs``; run its body eagerly
    on a copy of the pool taken before the replay; outputs, pool bytes
    and positions must be equal.  The NULL page is left out: bucket
    padding lands there, several positions on one offset, and which of
    those writes lands last is not defined (nothing reads the page).
    Returns the replay's outputs."""
    pool0 = {k: t.clone() for k, t in graphs.pool.items()}
    g = graphs.get(key)
    g.set(**fields)
    if logits is not None:
        g.logits.copy_(logits)
    out = [t.clone() for t in graphs.run(g)]
    twin = PrefillGraphs(graphs.params, graphs.cfg, pool0, graphs.device)
    e = twin.get(key)
    e.set(**fields)
    if logits is not None:
        e.logits.copy_(logits)
    e.upload()
    for a, b in zip(out, twin.body(e)):
        assert torch.equal(a, b), key
    for name, t in graphs.pool.items():
        real = t if name == "pos" else t[:, serving.NULL_PAGE + 1:]
        want = pool0[name] if name == "pos" else \
            pool0[name][:, serving.NULL_PAGE + 1:]
        assert torch.equal(real, want), (key, name)
    return out


def test_admission_graphs_bit_identical_to_eager(dev):
    """Each kind of admission graph against its body run eagerly on a
    copy of the same pool: a whole-prompt prefill of two prompts
    (``("full", 64, 2)``), one suffix graph (``("suffix", 8, 32, 2)``)
    captured once and replayed at prefix lengths 75 and 120 (K1's shift
    read from the device), a chunk (``("suffix", 2, 32, 1)``) and the
    first-token sampler (``("sample", 2)``).  K1 launches once a layer
    a prefill replay, and each key is captured once."""
    engine, cfg = _serving_engine(dev, overlap=False)
    graphs, slots = engine._graphs, engine.slots
    rng = np.random.default_rng(3)
    a, b = slots.alloc(), slots.alloc()
    for s in (a, b):
        for idx in range(10):
            slots.grant(s, idx)
    lens = np.array([50, 33])
    new_pos, phys, off = slots.landing([a, b], lens, bucket=64)
    full = dict(tokens=rng.integers(0, 32000, (2, 64)), lens=lens,
                slots=[a, b], new_pos=new_pos, valid=1, phys=phys, off=off)
    logits, _, _ = _graph_equals_body(graphs, ("full", 64, 2), full)
    g = graphs.get(("full", 64, 2))
    assert g.k1_launches_per_replay == cfg.n_layers
    k1 = A.flash_fwd_launches
    graphs.run(g)  # a replay: K1 once a layer, nothing else counted
    assert A.flash_fwd_launches - k1 == cfg.n_layers
    # One suffix graph, two prefix lengths: slot a's first 75 and 120
    # positions (its pages NULL-padded from 5 and 8 to 8) before
    # suffixes of 20 and 7 tokens.
    for p0 in (75, 120):
        lens = np.array([20, 7])
        new_pos, phys, off = slots.landing([a, b], lens, p0, bucket=32)
        _graph_equals_body(graphs, ("suffix", 8, 32, 2), dict(
            tokens=rng.integers(0, 32000, (2, 32)), lens=lens, p0=p0,
            pages=pad_pages(slots.table[a, :slots.pages_for(p0)].tolist()),
            slots=[a, b], new_pos=new_pos, valid=1, phys=phys, off=off))
    new_pos, phys, off = slots.landing([b], [32], 32, bucket=32)
    _graph_equals_body(graphs, ("suffix", 2, 32, 1), dict(
        tokens=rng.integers(0, 32000, (1, 32)), lens=[32], p0=32,
        pages=slots.table[b, :2].tolist(), slots=[b], new_pos=new_pos,
        valid=1, phys=phys, off=off))
    _graph_equals_body(graphs, ("sample", 2), dict(
        temp=[0.0, 0.9], top_k=[0, 40], top_p=[0.0, 0.95], pos=[51, 34],
        keys=np.stack([serving.seed_key(s) for s in (1, 2)])), logits=logits)
    assert graphs.captures == {"full": 1, "suffix": 2, "sample": 1}
    engine.terminate()


def test_one_capture_per_admission_shape(dev):
    """After ``warmup`` over the burst's prompt lengths, a mixed burst
    (greedy and sampled, eight buckets, K = 2) and a registered prefix's
    sharers (warmed too) capture nothing more: each key used was
    captured once, ``prefill_compilations`` counts them, and
    ``decode_compilations`` stays 1."""
    engine, cfg = _serving_engine(dev)
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 32000, 75).tolist()
    engine.register_prefix(prefix)
    engine.warmup((5, 40, 100, 17, 300, 64, 9, 200))
    st = engine.stats()
    warm = (st["prefill_compilations"], st["sample_compilations"])
    assert warm[0] == len(st["prefill_buckets"]) + len(
        st["prefill_suffix_shapes"])
    assert warm[1] == 2  # k = 1, 2
    futs = _mixed_requests(engine, 16)
    futs += [engine.submit(prefix + rng.integers(0, 32000, n).tolist(),
                           max_new_tokens=16, **kw)
             for n, kw in zip((9, 40, 100), SAMPLING)]
    while not all(f.done() for f in futs):
        engine.step()
    assert all(len(f.result(timeout=0)) == 16 for f in futs)
    st = engine.stats()
    assert (st["prefill_compilations"], st["sample_compilations"]) == warm
    assert st["decode_compilations"] == 1
    engine.unregister_prefix(prefix)


def test_restart_and_cow_keep_the_admission_captures(dev):
    """Sharers of a prefix whose last page is partial (each copies it on
    write) through a decode fault: the restart zeroes the pool in place
    and re-prefills the prefix through its captured graph; every request
    resumes to its full count; no graph is recaptured and every pool
    tensor keeps its address."""
    inj = serving.FaultInjector()
    engine, cfg = _serving_engine(dev, faults=inj)
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, 32000, 75).tolist()
    engine.register_prefix(prefix)
    # Suffix buckets 8-128: the sharers' and their resumes' (suffix plus
    # the tokens emitted before the fault).
    engine.warmup((5, 16, 30, 64, 100))
    ptrs = {k: t.data_ptr() for k, t in engine.slots.cache.items()}
    st = engine.stats()
    caps = (st["prefill_compilations"], st["sample_compilations"],
            st["decode_compilations"])
    futs = [engine.submit(prefix + rng.integers(0, 32000, n).tolist(),
                          max_new_tokens=24, **kw)
            for n, kw in zip((5, 30, 8, 40), SAMPLING)]
    while sum(len(f.tokens_so_far()) for f in futs) < 20:
        engine.step()
    inj.add(serving.FaultSpec(site="decode_tick", kind="raise",
                              skip=inj.visits("decode_tick")))
    while not all(f.done() for f in futs):
        engine.step()
    assert all(len(f.result(timeout=0)) == 24 for f in futs)
    st = engine.stats()
    assert st["engine_restarts"] == 1 and st["requests_resumed"] >= 1
    assert (st["prefill_compilations"], st["sample_compilations"],
            st["decode_compilations"]) == caps
    assert engine._graphs.pool is engine.slots.cache
    assert {k: t.data_ptr() for k, t in engine.slots.cache.items()} == ptrs
    engine.unregister_prefix(prefix)


def test_flash_launches_count_replays(dev):
    """K1's counter grows by the layers of each prefill replay (and the
    capture's own launches are not counted): three admissions of one
    warmed shape add three replays' worth."""
    engine, cfg = _serving_engine(dev, overlap=False)
    engine.warmup((40,))
    replays, k1 = engine._graphs.replays, A.flash_fwd_launches
    for i in range(3):
        fut = engine.submit([i + 1] * 40, max_new_tokens=2)
        while not fut.done():
            engine.step()
    assert engine._graphs.replays - replays == 3
    assert A.flash_fwd_launches - k1 == 3 * cfg.n_layers


# --- speculative decoding ------------------------------------------------------


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("W", [4, 5])
def test_paged_kernel_at_verify_rows(dev, kv, W):
    """K4 at the speculative verify's R = G * W (G = 4: 16 and 20 rows,
    two and three row blocks) on the edge table, against its plain
    version; a second call gives the same bits."""
    args, table, limit = _edge_case(kv, dev)
    g = torch.Generator(device=dev).manual_seed(W)
    qg = torch.randn((8, 4, 4 * W, 64), generator=g, device=dev)
    args = [qg] + list(args[1:])
    o, lse = PA.paged_attend(*args, table, limit,
                             compute_dtype=torch.float32)
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


def _spec_engine(dev, draft, **kw):
    """A speculative serving engine at the serving width (max_len 512):
    ``draft`` "ngram", "self" (the target as its own draft) or "half"
    (the target's first four layers)."""
    cfg = T.TransformerConfig(**SERVE, dtype=torch.bfloat16)
    params = T.init_params(cfg, seed=0, device=dev)
    dp = dc = None
    if draft == "self":
        dp, dc = params, cfg
    elif draft == "half":
        dc = T.TransformerConfig(**{**SERVE, "n_layers": 4},
                                 dtype=torch.bfloat16)
        dp = {**params, "layers": {k: v[:4].contiguous()
                                   for k, v in params["layers"].items()}}
    ec = serving.EngineConfig(n_slots=8, max_len=512, page_size=16,
                              speculative=True, **kw)
    return (serving.InferenceEngine(params, cfg, ec, device=dev,
                                    draft_params=dp, draft_cfg=dc),
            cfg, dc)


@pytest.mark.parametrize("draft", ["ngram", "self", "half"])
def test_spec_tick_bit_identical_to_eager(dev, draft):
    """Twenty replays of the captured speculative tick over a live mix
    (greedy slots speculating, sampled ones at acceptance 0, one slot
    leaving halfway; the adaptive control off, so the n-gram slots keep
    speculating) against its eager body run from a copy of the same
    state: equal accepted lengths, emitted windows ``t[s, :acc + 1]`` and
    their max logits, pool bytes (the NULL page aside: rejected drafts
    race to it, and no slot attends it), positions and draft state; K4
    launches L (+ (k + 1) L_draft) a replay, L of them at R = G * (k +
    1)."""
    engine, cfg, dcfg = _spec_engine(dev, draft, overlap=False,
                                     spec_adaptive=False)
    engine.warmup((8,))
    assert engine.stats()["decode_compilations"] == 2
    _mixed_requests(engine, 120)
    while engine.scheduler.depth or engine.slots.active_count < 8:
        engine.step()
    engine.step()
    k = engine.engine_cfg.spec_k
    ps = engine.slots.page_size
    for s in range(8):
        p0 = int(engine._page_pos[s])
        for idx in range(p0 // ps, (p0 + 20 * (k + 1) + k) // ps + 1):
            if engine.slots.table[s, idx] == serving.NULL_PAGE:
                engine.slots.grant(s, idx)
            d = engine.draft_slots
            if d is not None and d._active[s] and \
                    d.table[s, idx] == serving.NULL_PAGE:
                d.grant(s, idx)
    engine._prepare_tick()
    tick = engine._spec_tick
    assert tick.spec_on.any()
    tick.plain.tokens.copy_(torch.from_numpy(engine._host_tokens()))
    tick.active.fill_(True)
    engine._samp.device()
    eager = tick.twin()
    k4, rows = PA.paged_attend_launches, dict(PA.paged_attend_launches_by_rows)
    replays = tick.replays
    graphed = []
    for i in range(20):
        if i == 10:
            tick.active[3] = False
        graphed.append([x.clone() for x in tick.run()])
    assert tick.replays - replays == 20
    per = cfg.n_layers + (0 if dcfg is None else (k + 1) * dcfg.n_layers)
    assert PA.paged_attend_launches - k4 == 20 * per
    R = 4 * (k + 1)
    assert PA.paged_attend_launches_by_rows[R] - rows.get(R, 0) == \
        20 * cfg.n_layers
    for i in range(20):
        if i == 10:
            eager.active[3] = False
        t, mx, acc = eager.body()
        assert torch.equal(acc, graphed[i][2]), i
        # Offsets past a row's accepted run read drafts that rows with no
        # draft pages (sampled ones) build from the NULL page: only the
        # emitted part t[s, :acc + 1] is defined.
        keep = torch.arange(t.shape[1], device=dev)[None, :] <= acc[:, None]
        assert torch.equal(t[keep], graphed[i][0][keep]), i
        assert torch.equal(mx[keep], graphed[i][1][keep]), i
        assert torch.equal(t[:, 0], graphed[i][0][:, 0]), i
    for name, t in tick.plain.pool.items():
        want = eager.plain.pool[name]
        if name == "pos":
            assert torch.equal(t, want)
        else:
            assert torch.equal(t[:, 1:], want[:, 1:]), name
    if dcfg is None:
        assert torch.equal(tick.hist[:, :-1], eager.hist[:, :-1])
    else:
        for name, t in tick.draft[2].items():
            want = eager.draft[2][name]
            assert torch.equal(t if name == "pos" else t[:, 1:],
                               want if name == "pos" else want[:, 1:]), name
    assert engine.stats()["decode_compilations"] == 2
    engine.terminate()


@pytest.mark.parametrize("draft", ["ngram", "half"])
def test_spec_two_captures_across_a_mixed_burst(dev, draft):
    """decode_compilations is 2 (the speculative tick and the plain one)
    after warmup and after a burst of greedy, sampled and opted-out
    requests; no admission graph is captured past the warmup, the draft
    model's included; every request returns its full count; K4's count
    grows by each graph's replays times its launches a replay."""
    engine, cfg, dcfg = _spec_engine(dev, draft)
    engine.warmup((8, 16, 32, 64, 128, 256, 500))
    st = engine.stats()
    assert st["decode_compilations"] == 2
    pre = st["prefill_compilations"]
    k4 = PA.paged_attend_launches
    r_spec, r_plain = engine._spec_tick.replays, engine._tick.replays
    futs = _mixed_requests(engine, 24)
    futs.append(engine.submit([7] * 30, max_new_tokens=24,
                              speculative=False))
    while not all(f.done() for f in futs):
        engine.step()
    assert all(len(f.result(timeout=0)) == 24 for f in futs)
    st = engine.stats()
    assert st["decode_compilations"] == 2
    assert st["prefill_compilations"] == pre
    n_spec = engine._spec_tick.replays - r_spec
    n_plain = engine._tick.replays - r_plain
    assert n_spec > 0
    assert PA.paged_attend_launches - k4 == (
        n_spec * engine._spec_tick.k4_launches_per_replay
        + n_plain * cfg.n_layers)
    assert st["spec_drafted_tokens"] > 0


# --- the captured train step and the collectives (size-1 NCCL) -----------------


@pytest.fixture()
def nccl(dev):
    import socket

    from horovod_tpu_torch import basics

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    basics.init(init_method=f"tcp://127.0.0.1:{port}")
    yield dev
    basics.shutdown()


TRAIN_CFG = dict(vocab_size=256, d_model=256, n_heads=4, n_layers=2,
                 d_ff=512, max_seq=128, attention_impl="flash")


def _train_pair(dev, k):
    """Two copies of one f32 model and optimizer (TF32 off): a captured
    ``TrainStep`` and the eager body of another."""
    from horovod_tpu_torch import optim, spmd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = T.TransformerConfig(**TRAIN_CFG, dtype=torch.float32)
    steps = []
    for _ in range(2):
        p = T.init_params(cfg, seed=3, device=dev, param_dtype=torch.float32)
        named = optim.named_parameters(p)
        for _, t in named:
            t.requires_grad_()
        opt = optim.DistributedOptimizer(
            torch.optim.AdamW([t for _, t in named], lr=1e-3,
                              weight_decay=1e-4),
            named_parameters=named, backward_passes_per_step=k)
        steps.append((p, spmd.make_train_step(
            lambda p, b: T.loss_fn(p, b, cfg), opt)))
    batches = [T.synthetic_batch(s, cfg, 2, 128, device=dev)
               for s in range(6)]
    return steps, batches


@pytest.mark.parametrize("k", [1, 2])
def test_captured_step_bit_identical_to_eager(nccl, k):
    """The captured step (warm-up, one capture, replays; two graphs at
    k = 2, the accumulate pass and the boundary pass) against its own
    eager body, call for call: losses and every parameter bit for bit
    (the same kernels on the same inputs, at f32 with TF32 off)."""
    from horovod_tpu_torch.optim import named_parameters

    ((pg, graphed), (pe, eager)), batches = _train_pair(nccl, k)
    assert graphed.graphed
    for b in batches:
        lg, le = graphed(pg, b), eager.body(pe, b)
        assert torch.equal(lg, le)
        for (n, a), (_, e) in zip(named_parameters(pg),
                                  named_parameters(pe)):
            assert torch.equal(a, e), n
    assert graphed.captures == (1 if k == 1 else 2)
    assert graphed.replays == len(batches) - 2


def _same_state(graphed_out, eager_out, pg, pe):
    from horovod_tpu_torch.optim import named_parameters

    assert torch.equal(graphed_out, eager_out)
    for (n, a), (_, e) in zip(named_parameters(pg), named_parameters(pe)):
        assert torch.equal(a, e), n


def test_captured_step_follows_the_lr_schedule(nccl):
    """An LR scheduler stepped after every call, then a float ``lr`` set
    by hand: the replays read AdamW's device-tensor ``lr`` and equal the
    eager body call for call, with no capture past the first."""
    ((pg, graphed), (pe, eager)), batches = _train_pair(nccl, 1)
    scheds = [torch.optim.lr_scheduler.LambdaLR(
        s.optimizer, lambda i: 1.0 / (1 + i)) for s in (graphed, eager)]
    for i, b in enumerate(batches):
        if i == 4:
            for s in (graphed, eager):
                for g in s.optimizer.param_groups:
                    g["lr"] = 2e-3
        _same_state(graphed(pg, b), eager.body(pe, b), pg, pe)
        if i < 4:
            for sc in scheds:
                sc.step()
    assert graphed.optimizer.param_groups[0]["lr"].is_cuda
    assert graphed.captures == 1
    assert graphed.replays == len(batches) - 2


@pytest.mark.parametrize("k", [1, 2])
def test_captured_step_captures_each_shape_and_setting(nccl, k):
    """A short batch and another sequence length are captured at their
    first call (the JAX step retraces), a shape seen before replays its
    graphs, and a changed ``weight_decay`` drops the graphs and captures
    anew: every call equals the eager body bit for bit."""
    from horovod_tpu_torch.models import transformer as TT

    ((pg, graphed), (pe, eager)), batches = _train_pair(nccl, k)
    cfg = TT.TransformerConfig(**TRAIN_CFG, dtype=torch.float32)
    short = TT.synthetic_batch(7, cfg, 1, 128, device=nccl)
    seq64 = TT.synthetic_batch(8, cfg, 2, 64, device=nccl)
    calls = batches[:3] + [short, batches[3], seq64, short, batches[4]]
    for i, b in enumerate(calls):
        if i == 6:
            for s in (graphed, eager):
                for g in s.optimizer.param_groups:
                    g["weight_decay"] = 1e-2
        _same_state(graphed(pg, b), eager.body(pe, b), pg, pe)
    per_shape = 1 if k == 1 else 2
    # full, short, seq64; then short and full again after the change.
    assert graphed.captures == 5 * per_shape
    assert graphed.replays == len(calls) - 2


def test_captured_step_counts_launches_per_replay(nccl):
    """K1, K2 and K3 each count once a layer a call under the graph, the
    warm-up's eager calls and every replay alike, none at the capture."""
    ((pg, graphed), _), batches = _train_pair(nccl, 1)
    before = (A.flash_fwd_launches, A.flash_bwd_dkdv_launches,
              A.flash_bwd_dq_launches)
    for b in batches:
        graphed(pg, b)
    after = (A.flash_fwd_launches, A.flash_bwd_dkdv_launches,
             A.flash_bwd_dq_launches)
    L = TRAIN_CFG["n_layers"]
    assert [a - b for a, b in zip(after, before)] == [L * len(batches)] * 3


def test_remat_launches_k1_twice_a_layer(dev):
    """Under both remat policies the backward reruns K1 once a layer;
    K2 and K3 run once a layer."""
    cfg0 = T.TransformerConfig(**TRAIN_CFG, dtype=torch.bfloat16)
    p = T.init_params(cfg0, seed=1, device=dev, param_dtype=torch.float32)
    for t in p["layers"].values():
        t.requires_grad_()
    b = T.synthetic_batch(0, cfg0, 2, 128, device=dev)
    for policy in ("full", "dots"):
        cfg = T.TransformerConfig(**TRAIN_CFG, dtype=torch.bfloat16,
                                  remat=True, remat_policy=policy)
        k1, k2, k3 = (A.flash_fwd_launches, A.flash_bwd_dkdv_launches,
                      A.flash_bwd_dq_launches)
        T.loss_fn(p, b, cfg).backward()
        L = cfg.n_layers
        assert (A.flash_fwd_launches - k1, A.flash_bwd_dkdv_launches - k2,
                A.flash_bwd_dq_launches - k3) == (2 * L, L, L), policy


def test_every_collective_on_cuda_at_size_one(nccl):
    """``chip_smoke.check_collectives``: every op on CUDA tensors, f32 and
    bf16, each equal to its size-1 value (43 checks a dtype, then the
    object collectives, ``join`` and the barrier)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert len(chip_smoke.check_collectives(nccl)) == 2 * 43 + 4


# --- the vision path: the captured ResNet step, the loader, the FLOP count -----


@pytest.fixture()
def deterministic_cudnn():
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved


def test_captured_resnet_step_equals_eager_body(nccl, deterministic_cudnn):
    """The bench's ResNet step (bf16, channels_last, SGD with momentum)
    captured against its eager body on a second copy of the model, call
    for call under ``cudnn.deterministic``: the loss, every parameter and
    every batch statistic bit for bit."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import resnet

    pairs = []
    for _ in range(2):
        model = resnet.create("ResNet18", 10, num_filters=16, seed=3,
                              device=nccl).train()
        pairs.append((model, bench.make_step(model)))
    (mg, graphed), (me, eager) = pairs
    g = torch.Generator(device=nccl).manual_seed(0)
    batches = [{"images": torch.rand((8, 3, 64, 64), generator=g,
                                     device=nccl).to(torch.bfloat16)
                .contiguous(memory_format=torch.channels_last),
                "labels": torch.randint(0, 10, (8,), generator=g,
                                        device=nccl)} for _ in range(5)]
    for b in batches:
        assert torch.equal(graphed(mg, b), eager.body(me, b))
        for (n, a), (_, e) in zip(mg.state_dict().items(),
                                  me.state_dict().items()):
            assert torch.equal(a, e), n
    assert graphed.captures == 1
    assert graphed.replays == len(batches) - 2


def test_loader_prefetch_on_the_card(dev):
    """Prefetched batches equal the host rows and arrive in channels_last
    on the card; a batch dropped by the host while the consuming stream
    still has to read it stays intact while the next copies land (the
    stream is held back by a spin before each read, and each batch's
    reference is dropped at once: without ``record_stream`` the allocator
    hands its memory to the next copy)."""
    from horovod_tpu_torch.data import DataLoader

    nhwc = torch.randn((48, 32, 32, 3)).to(torch.bfloat16)
    images = nhwc.permute(0, 3, 1, 2)
    labels = np.arange(48)
    for shuffle in (False, True):
        dl = DataLoader({"images": images, "labels": labels}, 8,
                        shuffle=shuffle, prefetch=2, device=dev)
        kept = []
        for b in dl:
            assert b["images"].is_cuda
            assert b["images"].is_contiguous(
                memory_format=torch.channels_last)
            torch.cuda._sleep(20_000_000)
            kept.append((b["images"].clone(), b["labels"].clone()))
            del b
        torch.cuda.synchronize()
        assert len(kept) == len(dl) == 6
        for got, rows in kept:
            assert torch.equal(got.cpu(), images[rows.cpu()])


def test_introspect_counts_resnet50_flops(dev):
    """``xprof.introspect`` over one bf16 ResNet-50 step at 224 × 224
    counts within 10 % of the analytic 3 × 8.2 GFLOP an image (a forward
    of 4.1 G multiply-adds, and a backward twice that), and reads a peak
    memory."""
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.obs import xprof

    model = resnet.create("ResNet50", device=dev).train()
    x = torch.rand((4, 3, 224, 224), device=dev).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    y = torch.randint(0, 1000, (4,), device=dev)

    def step(m, x, y):
        loss = torch.nn.functional.cross_entropy(m(x), y)
        loss.backward()
        return loss

    loss, report = xprof.introspect(step, model, x, y)
    per_img = report.flops / 4
    assert abs(per_img - 3 * 8.2e9) <= 0.1 * 3 * 8.2e9, per_img
    assert report.peak_mem_bytes and report.peak_mem_bytes > 0
    assert torch.isfinite(loss)


def test_capture_holds_off_the_garbage_collector(dev):
    """Every capture of the port runs with Python's automatic garbage
    collection off (a collection midway can free an object whose
    destructor calls CUDA and invalidate the capture) and restores it."""
    import gc

    from horovod_tpu_torch._capture import capture

    x = torch.ones(4, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        x.add_(1)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    assert gc.isenabled()
    with capture(graph):
        seen = gc.isenabled()
        x.add_(1)
    assert not seen and gc.isenabled()
    graph.replay()
    torch.cuda.synchronize(dev)
    assert torch.equal(x.cpu(), torch.full((4,), 3.0))


# -- tracing around the captured paths ---------------------------------------


@pytest.fixture()
def traced(tmp_path):
    """A request tracer (timeline + JSONL) and a span recorder, active
    for the test and stopped after it."""
    from horovod_tpu_torch.obs import tracing as TR

    TR.start(str(tmp_path / "trace.json"),
             jsonl_path=str(tmp_path / "events.jsonl"))
    TR.start_spans(str(tmp_path / "spans" / "engine.jsonl"))
    yield tmp_path
    TR.stop_spans()
    TR.stop()


def test_graphs_captured_under_a_tracer_equal_eager(dev, traced):
    """With a tracer and a span recorder active, each capture (the tick,
    every admission graph kind) puts its instant on the timeline's queue
    from inside the capture and nothing else: the graphs still equal
    their eager bodies bit for bit, and each capture left one
    ``xla_compile`` instant."""
    import json

    from horovod_tpu_torch.obs import tracing as TR
    from horovod_tpu_torch.obs.registry import training_metrics

    names = ("serving_decode", "serving_prefill", "serving_sample")
    fam = training_metrics().compiles
    before = {n: fam.labels(fn=n).value for n in names}
    test_captured_tick_bit_identical_to_eager(dev)
    test_admission_graphs_bit_identical_to_eager(dev)
    TR.stop()  # closes the timeline file
    events = json.loads((traced / "trace.json").read_text())
    fns = [e["args"]["fn"] for e in events if e["name"] == "xla_compile"]
    got = {n: fam.labels(fn=n).value - before[n] for n in names}
    assert {n: fns.count(n) for n in names} == got
    # One tick; the admission graphs of both tests (warmed and at first
    # use), at least one of each kind.
    assert got["serving_decode"] == 1
    assert got["serving_prefill"] >= 3 and got["serving_sample"] >= 1


@pytest.mark.parametrize("draft", ["plain", "half"])
def test_record_compile_counts_equal_the_captures(dev, draft):
    """``xla_compiles_total{fn=}`` grows by the engine's captures, under
    the JAX engine's function names: ``serving_decode`` (the tick, and
    the speculative tick), ``serving_prefill`` (whole-prompt and suffix
    prefills), ``serving_sample`` and, for a model draft,
    ``serving_draft_prefill``."""
    from horovod_tpu_torch.obs.registry import training_metrics

    fam = training_metrics().compiles
    names = ("serving_decode", "serving_prefill", "serving_sample",
             "serving_draft_prefill")
    before = {n: fam.labels(fn=n).value for n in names}
    if draft == "plain":
        engine, cfg = _serving_engine(dev)
    else:
        engine, cfg, _ = _spec_engine(dev, draft)
    engine.warmup((8, 40))
    futs = _mixed_requests(engine, 8)
    while not all(f.done() for f in futs):
        engine.step()
    got = {n: fam.labels(fn=n).value - before[n] for n in names}
    g = engine._graphs.captures
    dg = engine._draft_graphs.captures if engine._draft_graphs else \
        {"full": 0, "suffix": 0}
    want = {"serving_decode": engine.stats()["decode_compilations"],
            "serving_prefill": g["full"] + g["suffix"],
            "serving_sample": g["sample"],
            "serving_draft_prefill": dg["full"] + dg["suffix"]}
    assert got == want
    assert want["serving_decode"] == (1 if draft == "plain" else 2)
    assert (want["serving_draft_prefill"] > 0) == (draft == "half")
    engine.terminate()


def test_profile_records_k4_in_a_captured_tick(dev, tmp_path):
    """``Timeline.profile`` around replays of the captured tick: the
    exported Chrome trace names K4's split and combine kernels (kernels
    replayed from a CUDA graph included), and ``obs.merge`` merges it
    with the host timeline into one file holding both."""
    import json

    from horovod_tpu_torch import timeline as TL
    from horovod_tpu_torch.obs import merge as M

    engine, cfg = _serving_engine(dev)
    engine.warmup((8,))
    futs = _mixed_requests(engine, 40)
    while engine.scheduler.depth or engine._taken:
        engine.step()
    host = tmp_path / "host.rank0.json"
    tl = TL.Timeline(str(host))
    replays = engine._tick.replays
    with tl.profile(str(tmp_path / "prof"), device=dev):
        for _ in range(5):
            engine.step()
    tl.instant("profiled")
    tl.close()
    assert engine._tick.replays - replays == 5
    trace = json.loads(open(tl.profile_path).read())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    for k in ("paged_attend_split_kernel", "paged_attend_combine_kernel"):
        assert any(k in n for n in names), k
    out = tmp_path / "merged.json"
    assert M.main([str(out), str(host), tl.profile_path]) == 0
    merged = json.loads(out.read_text())
    assert {e["pid"] // M.PID_STRIDE for e in merged} == {1, 2}
    while not all(f.done() for f in futs):
        engine.step()


# --- the serving fleet: a CUDA replica, the online tuner ----------------------


def test_cuda_replica_answers_through_replica_main(dev, tmp_path):
    """One CUDA replica process spawned by the supervisor from the port's
    ``dump_model`` pickle (its own CUDA context) answers through the
    router: 200 with its full token count, and its ``/stats`` shows the
    card, K1 and K4 launched in that process, one tick capture and no
    admission capture after warmup."""
    import json
    import urllib.request

    from horovod_tpu_torch.serving.router import (ReplicaRegistry,
                                                  ReplicaSpec,
                                                  ReplicaSupervisor,
                                                  RouterServer)
    from horovod_tpu_torch.serving.router.replica_main import dump_model

    cfg = T.TransformerConfig(**SERVE, dtype=torch.bfloat16)
    pkl = str(tmp_path / "model.pkl")
    dump_model(pkl, T.init_params(cfg, seed=0, device=dev), cfg)
    spec = ReplicaSpec(params_path=pkl, slots=4, warm=(8, 16, 32, 64),
                       device="cuda", request_timeout=120.0)
    reg = ReplicaRegistry(poll_interval=0.2, heartbeat_stale=60.0)
    sup = ReplicaSupervisor(spec, 1, registry=reg, startup_timeout=240.0,
                            log_dir=str(tmp_path / "logs"))
    rt = RouterServer(reg, port=0, proxy_timeout=120.0)
    sup.start()
    rt.start()
    try:
        assert sup.wait_ready(timeout=240), \
            (tmp_path / "logs" / "r0g0.log").read_text()[-2000:]
        st0 = json.loads(urllib.request.urlopen(
            reg.in_rotation()[0].endpoint.base_url + "/stats").read())
        host, port = rt.address
        req = urllib.request.Request(
            f"http://{host}:{port}/generate",
            data=json.dumps({"tokens": list(range(1, 41)),
                             "max_new_tokens": 16}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            assert r.headers["X-Router-Replica"] == "r0g0"
            assert len(json.loads(r.read())["tokens"]) == 16
        st = json.loads(urllib.request.urlopen(
            reg.in_rotation()[0].endpoint.base_url + "/stats").read())
        assert st["device"].startswith("cuda")
        assert st["flash_fwd_launches"] > st0["flash_fwd_launches"]
        assert st["paged_attend_launches"] > st0["paged_attend_launches"]
        assert st["decode_compilations"] == 1
        assert st["prefill_compilations"] == st0["prefill_compilations"]
    finally:
        rt.stop()
        sup.stop()


def test_autotuner_applies_every_knob_value_without_capture(dev):
    """Every value of every knob in the online space of a warmed CUDA
    engine (chunked, so the chunk knob is in it) applied in turn, each
    followed by a burst of mixed lengths (chunked prompts included): no
    decode, admission or sampler capture past the warmup, every request
    its full count.  Then the speculation gate on a speculative engine,
    both values: still two decode captures."""
    from horovod_tpu_torch.tuning import apply_settings, online_knob_space

    engine, _ = _serving_engine(dev, prefill_chunk_tokens=32)
    engine.warmup((8, 16, 32, 64, 128, 256, 500))
    space = online_knob_space(engine)
    by_name = {k.name: k for k in space.knobs}
    assert set(by_name) == {"max_prefills_per_tick",
                            "prefill_chunk_tokens", "page_grant_ahead"}
    assert by_name["prefill_chunk_tokens"].bounds == (17, 32)
    keys = ("decode_compilations", "prefill_compilations",
            "sample_compilations")
    warm = {k: engine.stats()[k] for k in keys}
    assert warm["decode_compilations"] == 1
    rng = np.random.default_rng(9)
    applied = 0
    for knob in space.describe():
        for value in knob["candidates"]:
            apply_settings(engine, {knob["name"]: value})
            applied += 1
            futs = [engine.submit(rng.integers(0, 32000, n).tolist(),
                                  max_new_tokens=6, **kw)
                    for n, kw in zip((5, 45, 130, 300), SAMPLING)]
            while not all(f.done() for f in futs):
                engine.step()
            assert all(len(f.result(timeout=0)) == 6 for f in futs)
            assert {k: engine.stats()[k] for k in keys} == warm, \
                (knob["name"], value)
        apply_settings(engine, {knob["name"]: knob["default"]})
    assert applied == 2 + 16 + 3
    engine.terminate()
    spec, _, _ = _spec_engine(dev, "ngram")
    spec.warmup((8, 16, 32, 64))
    assert "spec_enabled" in {k.name for k in online_knob_space(spec).knobs}
    for on in (False, True, False):
        apply_settings(spec, {"spec_enabled": on})
        futs = _mixed_requests(spec, 8)
        while not all(f.done() for f in futs):
            spec.step()
        assert spec.stats()["decode_compilations"] == 2
    spec.terminate()
