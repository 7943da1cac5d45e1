"""horovod_tpu_torch's training path against the JAX package, at f32 on
the CPU.

Same seeded numpy inputs through both packages: the JAX flash functions
run their Pallas kernels in interpret mode (as ``tests/test_attention.py``
does), the port its plain versions (``_reference_attention_lse``,
``_flash_bwd_reference``) — the CUDA kernels K1-K3 are held against
those on the card by ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``.

Tolerance: atol = rtol = 1e-5 throughout (f32 summation order differs
between XLA and PyTorch; nothing else may).  The two-process tests spawn
gloo workers that import only the port; the parent holds their results
against JAX.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu.ops import attention as JA
from horovod_tpu.ops import fusion as JF
from horovod_tpu_torch import basics, optim, spmd
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import attention as A
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops import fusion as F
from horovod_tpu_torch.ops.compression import Compression

TOL = dict(atol=1e-5, rtol=1e-5)
REPO = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_seq=16, n_kv_heads=2)
SEQ, BATCH = 16, 4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# --- 1. flash attention gradients ---------------------------------------------


def _inputs(seed, H=4, Hkv=4, S=64, D=32, B=1):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, S, D).astype(np.float32)
    k, v = (rng.randn(B, Hkv, S, D).astype(np.float32) for _ in range(2))
    w = rng.randn(B, H, S, D).astype(np.float32)   # cotangent of o
    wl = rng.randn(B, H, S).astype(np.float32)     # cotangent of lse
    return q, k, v, w, wl


def _compare(jax_fn, torch_fn, q, k, v, w, wl):
    """Value and (dq, dk, dv) of ``sum(o*w) + sum(lse*wl)`` through
    both; ``*_fn(q, k, v) -> (o, lse)``."""
    def jloss(q, k, v):
        o, lse = jax_fn(q, k, v)
        return jnp.sum(o * w) + jnp.sum(lse * wl)

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = torch_fn(*ts)
    tval = (o * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(wl)).sum()
    tval.backward()
    np.testing.assert_allclose(_np(tval), np.asarray(jval), **TOL)
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(_np(t.grad), np.asarray(g), **TOL)


class TestFlashGradients:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("Hkv", [4, 2], ids=["mha", "gqa"])
    def test_flash_attention(self, causal, Hkv):
        """o only (lse unused): the JAX side expands GQA K/V with
        ``expand_kv``, whose VJP is the group sum K2 computes."""
        q, k, v, w, _ = _inputs(0, Hkv=Hkv)
        wl = np.zeros(q.shape[:3], np.float32)
        H = q.shape[1]
        _compare(
            lambda q, k, v: (JA.flash_attention(
                q, JA.expand_kv(k, H), JA.expand_kv(v, H), causal),
                jnp.zeros(q.shape[:3])),
            lambda q, k, v: (A.flash_attention(q, k, v, causal),
                             torch.zeros(q.shape[:3])),
            q, k, v, w, wl)

    @pytest.mark.parametrize("causal", [False, True])
    def test_with_lse_nonzero_dlse(self, causal):
        q, k, v, w, wl = _inputs(1, Hkv=2)
        H = q.shape[1]
        _compare(
            lambda q, k, v: JA.flash_attention_with_lse(
                q, JA.expand_kv(k, H), JA.expand_kv(v, H), causal),
            lambda q, k, v: A.flash_attention_with_lse(q, k, v, causal),
            q, k, v, w, wl)

    @pytest.mark.parametrize("shift", [0, -64, 64, 23],
                             ids=["causal", "minus_T", "S", "middle"])
    def test_shifted(self, shift):
        """shift -T attends everything, S masks everything (o = 0,
        lse = NEG_INF and zero gradients), 23 a middle diagonal."""
        q, k, v, w, wl = _inputs(2, Hkv=2)
        H = q.shape[1]
        _compare(
            lambda q, k, v: JA.flash_attention_shifted(
                q, JA.expand_kv(k, H), JA.expand_kv(v, H), jnp.int32(shift)),
            lambda q, k, v: A.flash_attention_shifted(q, k, v, shift),
            q, k, v, w, wl)

    @pytest.mark.parametrize("G", [1, 4])
    @pytest.mark.parametrize("shift", [0, -64, None],
                             ids=["causal", "bottom_right", "full"])
    def test_bf16_plain_backward_matches_jax_kernels(self, shift, G):
        """The bf16 yardstick the tensor-core K2 (and K3) are held to on
        the card: the plain dk/dv (and dq) against the Pallas backward
        kernels (interpret mode, blocks of 32) at S=64 != T=128, on the
        JAX forward's o and lse, with a nonzero lse cotangent.
        Tolerance 2e-2 of the largest gradient: p and ds round to bf16 in
        both at the same points, but with GQA the JAX path rounds each
        query head's dk/dv to bf16 before the group sum and the plain
        version sums in f32 and rounds once (a few bf16 steps, 2^-8)."""
        rng = np.random.RandomState(6)
        H, S, T, D = 4, 64, 128, 32
        q, do = (rng.randn(2, H, S, D).astype(np.float32) for _ in range(2))
        k, v = (rng.randn(2, H // G, T, D).astype(np.float32)
                for _ in range(2))
        dlse = rng.randn(2, H, S).astype(np.float32)
        scale = D ** -0.5
        jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16)
                           for x in (q, k, v, do))
        jk, jv = JA.expand_kv(jk, H), JA.expand_kv(jv, H)
        o, lse = JA._flash_fwd(jq, jk, jv, shift, None, 32, 32)
        dq_j, dk_j, dv_j = JA._flash_bwd_pallas(
            shift, scale, 32, 32, jq, jk, jv, o, lse, jdo, jnp.asarray(dlse))
        tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                           for x in (q, k, v, do))
        to = torch.from_numpy(np.array(o, np.float32)).to(torch.bfloat16)
        tlse = torch.from_numpy(np.array(lse, np.float32))
        delta = (tdo.float() * to.float()).sum(-1) - torch.from_numpy(dlse)
        dk, dv = A._flash_bwd_dkdv_reference(tq, tk, tv, tdo, tlse, delta,
                                             shift, scale)
        dq = A._flash_bwd_dq_reference(tq, tk, tv, tdo, tlse, delta, shift,
                                       scale)

        def group_sum(x):  # the expanded heads' VJP: sum over each group
            return _np(x.astype(jnp.float32)).reshape(
                2, H // G, G, T, D).sum(2)

        for got, want in ((dk, group_sum(dk_j)), (dv, group_sum(dv_j)),
                          (dq, _np(dq_j.astype(jnp.float32)))):
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(got.float()), want, rtol=0,
                                       atol=2e-2 * np.abs(want).max())


# --- 2. the model's loss and gradients -----------------------------------------


def _cfgs(impl):
    return (JT.TransformerConfig(**CFG, dtype=jnp.float32, attention_impl=impl),
            T.TransformerConfig(**CFG, dtype=torch.float32,
                                attention_impl=impl))


def _jax_params(jcfg):
    return jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))


def _batch(seed, rows=BATCH):
    tok = np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                              (rows, SEQ)).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


def _torch_params(jparams, tcfg):
    p = params_from_jax(jparams, tcfg, device="cpu",
                        param_dtype=torch.float32)
    for _, t in optim.named_parameters(p):
        t.requires_grad_()
    return p


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _assert_tree_close(tparams, jtree, attr=None):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        node = tparams
        for key in path:
            node = node[key.key]
        got = node if attr is None else getattr(node, attr)
        np.testing.assert_allclose(_np(got), np.asarray(leaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_loss_and_every_gradient_match_jax(impl):
    jcfg, tcfg = _cfgs(impl)
    jparams, batch = _jax_params(jcfg), _batch(0)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg))(jparams)
    tparams = _torch_params(jparams, tcfg)
    loss = T.loss_fn(tparams, _torch_batch(batch), tcfg)
    loss.backward()
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **TOL)
    _assert_tree_close(tparams, jgrads, "grad")


def test_training_load_keeps_f32_and_casts_at_use():
    """param_dtype=f32 keeps every leaf f32 under a bf16 config; the
    forward casts each matrix at use, so its logits equal those of the
    serving load (matrices stored in bf16)."""
    _, tcfg = _cfgs("reference")
    cfg16 = T.TransformerConfig(**CFG, dtype=torch.bfloat16)
    jparams = _jax_params(_cfgs("reference")[0])
    train = params_from_jax(jparams, cfg16, device="cpu",
                            param_dtype=torch.float32)
    serve = params_from_jax(jparams, cfg16, device="cpu")
    assert all(t.dtype == torch.float32
               for _, t in optim.named_parameters(train))
    assert serve["layers"]["wq"].dtype == torch.bfloat16
    tok = _torch_batch(_batch(1))["tokens"]
    np.testing.assert_array_equal(_np(T.forward(train, tok, cfg16)),
                                  _np(T.forward(serve, tok, cfg16)))
    with pytest.raises(NotImplementedError, match="remat"):
        T.TransformerConfig(**CFG, remat=True)


def test_synthetic_batch_targets_are_the_roll():
    _, tcfg = _cfgs("flash")
    b = T.synthetic_batch(3, tcfg, 2, 8, device="cpu")
    assert b["tokens"].shape == (2, 8)
    assert int(b["tokens"].max()) < CFG["vocab_size"]
    assert torch.equal(b["targets"], torch.roll(b["tokens"], -1, 1))
    assert torch.equal(b["tokens"],
                       T.synthetic_batch(3, tcfg, 2, 8, device="cpu")["tokens"])


# --- 3. three AdamW steps against optax ----------------------------------------


@pytest.fixture()
def size_one():
    basics.init(device="cpu")
    yield
    basics.shutdown()


def _adamw(params):
    return torch.optim.AdamW([t for _, t in optim.named_parameters(params)],
                             lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def test_three_adamw_steps_match_optax(size_one):
    jcfg, tcfg = _cfgs("flash")
    jparams = _jax_params(jcfg)
    batches = [_batch(s) for s in (10, 11, 12)]
    opt = optax.adamw(3e-4)
    jp, state = jax.tree_util.tree_map(jnp.asarray, jparams), None
    state = opt.init(jp)
    jlosses = []
    for b in batches:
        loss, g = jax.value_and_grad(lambda p: JT.loss_fn(
            p, {k: jnp.asarray(v) for k, v in b.items()}, jcfg))(jp)
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        jlosses.append(float(loss))

    tparams = _torch_params(jparams, tcfg)
    dopt = optim.DistributedOptimizer(
        _adamw(tparams), named_parameters=optim.named_parameters(tparams))
    step = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, tcfg), dopt)
    tlosses = [float(step(tparams, _torch_batch(b))) for b in batches]
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    _assert_tree_close(tparams, jp)


def test_distributed_optimizer_rejects_bad_arguments(size_one):
    _, tcfg = _cfgs("reference")
    tparams = _torch_params(_jax_params(_cfgs("reference")[0]), tcfg)
    named = optim.named_parameters(tparams)
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        optim.DistributedOptimizer(_adamw(tparams),
                                   backward_passes_per_step=0)
    with pytest.raises(ValueError, match="duplicate"):
        optim.DistributedOptimizer(_adamw(tparams),
                                   named_parameters=named + named[:1])
    with pytest.raises(ValueError, match="exactly"):
        optim.DistributedOptimizer(_adamw(tparams),
                                   named_parameters=named[1:])
    with pytest.raises(ValueError, match="not ported"):
        C.allreduce(torch.ones(2), "Adasum")


# --- 4 and 5. two gloo processes; bucketing ------------------------------------


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from horovod_tpu_torch import basics, optim, spmd
    from horovod_tpu_torch.models import params_from_jax
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import collectives as C, fusion as F
    from horovod_tpu_torch.ops.compression import Compression

    inp, out = sys.argv[1], sys.argv[2]
    basics.init(device="cpu")
    r, n = basics.rank(), basics.size()
    assert n == 2, n
    data = np.load(inp)
    cfg = T.TransformerConfig(**json.loads(str(data["cfg"])),
                              dtype=torch.float32)
    tree = {"layers": {}}
    for name in data.files:
        if name.startswith("p."):
            key = name[2:]
            if key.startswith("layers."):
                tree["layers"][key[7:]] = data[name]
            else:
                tree[key] = data[name]

    def params():
        p = params_from_jax(tree, cfg, device="cpu",
                            param_dtype=torch.float32)
        for _, t in optim.named_parameters(p):
            t.requires_grad_()
        return p

    def rows(lo, hi):
        return {k: torch.from_numpy(data[k][lo:hi]).long()
                for k in ("tokens", "targets")}

    half = data["tokens"].shape[0] // 2
    mine = rows(r * half, (r + 1) * half)
    res = {}

    # The averaged gradient of the two halves (fused buckets).
    p = params()
    T.loss_fn(p, mine, cfg).backward()
    named = optim.named_parameters(p)
    red = optim.distributed_gradients([t.grad for _, t in named],
                                      fusion_threshold=1 << 16)
    for (name, _), g in zip(named, red):
        res["grad." + name] = g.numpy()

    # Fused equals unfused, mixed dtypes, both ops; fp16 on the wire.
    g = torch.Generator().manual_seed(5 + r)
    ts = [torch.randn(s, generator=g).to(dt) for s, dt in
          [((3, 4), torch.float32), ((7,), torch.float16), ((5,), torch.float32),
           ((2, 2), torch.float16), ((9,), torch.float32)]]
    for op in (C.Average, C.Sum):
        fused = F.fused_allreduce(ts, op, threshold=40)
        plain = [C.allreduce(t, op) for t in ts]
        for a, b in zip(fused, plain):
            assert a.dtype == b.dtype and torch.equal(a, b), (op, a, b)
    x = torch.full((4,), 1.0 + r)
    assert torch.equal(C.allreduce(x, C.Sum), torch.full((4,), 3.0))
    y = optim.distributed_gradients([x], compression=Compression.fp16)[0]
    assert y.dtype == torch.float32 and torch.equal(y, torch.full((4,), 1.5))
    got = C.allgather(torch.full((r + 1, 2), float(r)))
    assert torch.equal(got, torch.tensor([[0., 0.], [1., 1.], [1., 1.]]))
    assert torch.equal(C.broadcast(torch.tensor([r]), 1), torch.tensor([1]))
    C.barrier()

    # backward_passes_per_step=2 over two quarters: no update after the
    # first pass; after the second, one step of the full batch.
    p = params()
    if r == 1:  # broadcast_parameters repairs a diverged rank
        with torch.no_grad():
            p["head"].add_(1.0)
    optim.broadcast_parameters(p, root_rank=0)
    before = p["head"].detach().clone()
    opt = optim.DistributedOptimizer(
        torch.optim.AdamW([t for _, t in optim.named_parameters(p)],
                          lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                          weight_decay=1e-4),
        backward_passes_per_step=2)
    step = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt)
    q = half // 2
    step(p, rows(r * half, r * half + q))
    assert torch.equal(p["head"], before), "updated before the 2nd pass"
    step(p, rows(r * half + q, (r + 1) * half))
    for name, t in optim.named_parameters(p):
        res["step." + name] = t.detach().numpy()

    # A fresh optimizer on rank 1 receives rank 0's state.
    fresh = torch.optim.AdamW([t for _, t in optim.named_parameters(p)])
    if r == 0:
        fresh.load_state_dict(opt.state_dict())
    optim.broadcast_optimizer_state(fresh, root_rank=0)
    st0 = fresh.state_dict()["state"]
    assert len(st0) == len(optim.named_parameters(p))
    want = opt.state_dict()["state"]
    for i in st0:
        assert torch.equal(st0[i]["exp_avg"], want[i]["exp_avg"])
    basics.shutdown()
    if r == 0:
        np.savez(out, **res)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_match_the_full_batch(tmp_path):
    """Each of two processes takes half the batch: the averaged gradient
    equals the JAX full-batch gradient, and two accumulated quarter-batch
    passes (``backward_passes_per_step=2``) on each give the optax update
    of one full-batch step."""
    jcfg, tcfg = _cfgs("flash")
    jparams = _jax_params(jcfg)
    batch = _batch(20, rows=BATCH)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jgrads = jax.value_and_grad(lambda p: JT.loss_fn(p, jb, jcfg))(jparams)
    opt = optax.adamw(3e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    upd, _ = opt.update(jgrads, opt.init(jp), jp)
    jstep = optax.apply_updates(jp, upd)

    flat = {"p." + jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, cfg=json.dumps(CFG), **flat, **batch)
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(inp), str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    res = np.load(out)
    tgrads = {"layers": {}}
    tstep = {"layers": {}}
    for name in res.files:
        kind, key = name.split(".", 1)
        tree = tgrads if kind == "grad" else tstep
        if key.startswith("layers."):
            tree["layers"][key[7:]] = res[name]
        else:
            tree[key] = res[name]
    _assert_tree_close(tgrads, jgrads)
    _assert_tree_close(tstep, jstep)


def test_buckets_match_jax():
    """Mixed dtypes and sizes: the JAX package's greedy dtype-grouped
    buckets, index for index, at several thresholds."""
    shapes = [((3, 4), np.float32), ((100,), np.float16), ((7,), np.float32),
              ((2, 2), np.int32), ((64,), np.float32), ((5,), np.float16),
              ((), np.float32), ((9,), np.int32), ((30,), np.float32)]
    arrs = [np.zeros(s, dt) for s, dt in shapes]
    ts = [torch.from_numpy(a) for a in arrs]
    for threshold in (1, 40, 64, 200, 1 << 20):
        assert F.make_buckets(ts, threshold) == JF.make_buckets(arrs,
                                                                threshold)


def test_fused_allreduce_equals_unfused_at_size_one(size_one):
    ts = [torch.randn(3, 4), torch.randn(5).half(), torch.randn(2)]
    for op in (C.Average, C.Sum):
        for a, b in zip(F.fused_allreduce(ts, op, threshold=16), ts):
            assert a.shape == b.shape and torch.equal(a, b)


def test_fusion_threshold_env(monkeypatch):
    monkeypatch.delenv("HOROVOD_FUSION_THRESHOLD", raising=False)
    assert F.fusion_threshold_bytes() == 64 * 1024 * 1024
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1024")
    assert F.fusion_threshold_bytes() == 1024


def test_compression_round_trip():
    x = torch.randn(6, dtype=torch.float32)
    for comp, wire in ((Compression.fp16, torch.float16),
                       (Compression.bf16, torch.bfloat16)):
        t, ctx = comp.compress(x)
        assert t.dtype == wire
        back = comp.decompress(t, ctx)
        assert back.dtype == torch.float32
        assert torch.equal(back, x.to(wire).float())
    i = torch.arange(3)
    assert Compression.fp16.compress(i)[0] is i
    assert Compression.none.compress(x) == (x, None)


def test_basics_size_one_and_errors(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_NUM_PROC",
              "HOROVOD_LOCAL_RANK", "HOROVOD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not basics.is_initialized()
    with pytest.raises(basics.NotInitializedError):
        basics.size()
    basics.init(device="cpu")
    try:
        assert (basics.rank(), basics.size(), basics.local_rank(),
                basics.local_size()) == (0, 1, 0, 1)
        assert basics.device() == torch.device("cpu")
        basics.init(device="cpu")  # idempotent
    finally:
        basics.shutdown()
    monkeypatch.setenv("HOROVOD_RANK", "2")
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    with pytest.raises(ValueError, match="outside"):
        basics.init(device="cpu")
    monkeypatch.delenv("HOROVOD_RANK")
    monkeypatch.delenv("HOROVOD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        basics.init()
