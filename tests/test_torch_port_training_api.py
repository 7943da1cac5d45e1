"""horovod_tpu_torch's training API beyond slice 2 against the JAX package,
at f32 on the CPU: rematerialisation, the optimizers (Adasum as a reduce
op, the delta-model ``DistributedAdasumOptimizer``, ``sparse_keys``),
``DistributedGradientTape``, and ``make_train_step`` (``has_aux``, the
body the CUDA graph captures, ``backward_passes_per_step=2``,
``hierarchical=True`` over two hosts of two ranks).

The remat tests run in this process against the JAX ``loss_fn`` with the
same ``remat`` / ``remat_policy`` (the JAX flash path in interpret mode,
the port's plain versions).  The optimizer tests run one job of four
gloo processes, each case from the same initial parameters for three
steps on its quarter of each batch; the parent runs the JAX package's
jitted ``make_train_step`` over a sub-mesh of 4 virtual CPU devices on
the same batches.  The workers import only the port.

Tolerance: atol = rtol = 1e-5 (f32 summation order), but for the delta
model's parameters (``DELTA_TOL``, its comment says why).
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

from horovod_tpu import optim as JO
from horovod_tpu import spmd as JS
from horovod_tpu.models import transformer as JT
from horovod_tpu.ops import collectives as JC
from horovod_tpu_torch import basics, optim, spmd
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import attention as A
from horovod_tpu_torch.ops import sparse as SP

TOL = dict(atol=1e-5, rtol=1e-5)
# The delta model steps AdamW on each rank's own gradient (2 rows here)
# before any reduction.  Where that gradient is at the f32 noise floor
# (|g| ~ 1e-9 against JAX-to-torch differences of ~3e-8) AdamW's
# normalized step m / (sqrt(v) + eps) takes any value up to lr = 3e-4:
# one AdamW step from such a gradient, without Adasum, differs by up to
# 4.5e-5 between optax and torch.  So these two cases hold parameters
# to a third of a step.
DELTA_TOL = dict(atol=1e-4, rtol=1e-5)
REPO = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_seq=16, n_kv_heads=2)
SEQ, N, ROWS, STEPS, LR = 16, 4, 2, 3, 3e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _jax_params(jcfg):
    return jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))


def _batch(seed, rows):
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


def _flat(tree):
    return {jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


# --- 1. rematerialisation ------------------------------------------------------


@pytest.mark.parametrize("impl", ["flash", "reference"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_loss_and_every_gradient_match_jax(policy, impl):
    """The port's remat forward and backward against the JAX ``loss_fn``
    with the same policy, and bit for bit against the port without
    remat (recomputing runs the same operations)."""
    jcfg = JT.TransformerConfig(**CFG, dtype=jnp.float32,
                                attention_impl=impl, remat=True,
                                remat_policy=policy)
    jparams, batch = _jax_params(jcfg), _batch(0, 4)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg))(jparams)
    out = {}
    for remat in (True, False):
        tcfg = T.TransformerConfig(**CFG, dtype=torch.float32,
                                   attention_impl=impl, remat=remat,
                                   remat_policy=policy)
        tparams = _torch_params(jparams, tcfg)
        loss = T.loss_fn(tparams, _torch_batch(batch), tcfg)
        loss.backward()
        out[remat] = (loss, {n: t.grad for n, t in
                             optim.named_parameters(tparams)})
    loss, grads = out[True]
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **TOL)
    for name, want in _flat(jgrads).items():
        np.testing.assert_allclose(_np(grads[name]), want, **TOL,
                                   err_msg=name)
        assert torch.equal(grads[name], out[False][1][name]), name
    assert torch.equal(loss, out[False][0])


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_reruns_the_flash_forward_each_layer(policy, monkeypatch):
    """Under both policies the backward reruns the flash
    ``autograd.Function``'s forward (K1 on the card) once a layer, into a
    fresh output, and the flash backward (K2, K3) runs once a layer."""
    calls = {"fwd": [], "bwd": 0}
    fwd, bwd = A._forward, A._flash_bwd_reference

    def counted_fwd(*args):
        o, lse = fwd(*args)
        calls["fwd"].append(o)
        return o, lse

    def counted_bwd(*args):
        calls["bwd"] += 1
        return bwd(*args)

    monkeypatch.setattr(A, "_forward", counted_fwd)
    monkeypatch.setattr(A, "_flash_bwd_reference", counted_bwd)
    tcfg = T.TransformerConfig(**CFG, dtype=torch.float32,
                               attention_impl="flash", remat=True,
                               remat_policy=policy)
    tparams = _torch_params(_jax_params(JT.TransformerConfig(
        **CFG, dtype=jnp.float32)), tcfg)
    loss = T.loss_fn(tparams, _torch_batch(_batch(1, 2)), tcfg)
    L = CFG["n_layers"]
    assert len(calls["fwd"]) == L and calls["bwd"] == 0
    loss.backward()
    assert len(calls["fwd"]) == 2 * L and calls["bwd"] == L
    first, again = calls["fwd"][:L], calls["fwd"][L:]
    for a, b in zip(first, reversed(again)):  # backward runs last layer first
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)


def test_bad_remat_policy_raises_the_jax_error():
    with pytest.raises(ValueError) as e:
        T.TransformerConfig(**CFG, remat=True, remat_policy="offload")
    jcfg = JT.TransformerConfig(**CFG, remat=True, remat_policy="offload")
    with pytest.raises(ValueError) as je:
        JT._remat(lambda x, p: (x, None), jcfg)
    assert str(e.value) == str(je.value)


# --- 2. make_train_step at size 1 ------------------------------------------------


@pytest.fixture()
def size_one():
    basics.init(device="cpu")
    yield
    basics.shutdown()


def _adamw(params):
    return torch.optim.AdamW([t for _, t in optim.named_parameters(params)],
                             lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def test_train_step_body_equals_the_plain_step_and_has_aux(size_one):
    """Three steps of ``make_train_step`` (on the CPU its eager body, the
    body a CUDA graph captures) equal, bit for bit, the plain loop
    ``zero_grad, loss, backward, step, allreduce``; with ``has_aux`` the
    step returns ``(loss, aux)``, aux as the loss function returned it."""
    jparams = _jax_params(JT.TransformerConfig(**CFG, dtype=jnp.float32))
    tcfg = T.TransformerConfig(**CFG, dtype=torch.float32,
                               attention_impl="flash")
    batches = [_torch_batch(_batch(s, 2)) for s in (10, 11, 12)]

    def loss_aux(p, b):
        loss = T.loss_fn(p, b, tcfg)
        return loss, {"tokens": b["tokens"].numel(), "scaled": 2 * loss}

    p1 = _torch_params(jparams, tcfg)
    opt1 = optim.DistributedOptimizer(_adamw(p1))
    step = spmd.make_train_step(loss_aux, opt1, has_aux=True)
    assert not step.graphed and step.k == 1
    p2 = _torch_params(jparams, tcfg)
    opt2 = _adamw(p2)
    for b in batches:
        loss, aux = step(p1, b)
        opt2.zero_grad()
        want = T.loss_fn(p2, b, tcfg)
        want.backward()
        opt2.step()
        assert torch.equal(loss, want.detach())
        assert aux["tokens"] == 32 and torch.equal(aux["scaled"], 2 * loss)
        assert not aux["scaled"].requires_grad
    for (n, a), (_, b) in zip(optim.named_parameters(p1),
                              optim.named_parameters(p2)):
        assert torch.equal(a, b), n
    assert step.calls == 3 and step.captures == 0


def test_sparse_leaves_keep_names_and_order():
    named = [(f"layers.w{i}", torch.full((2, 2), float(i))) for i in range(3)]
    named.insert(1, ("embed", torch.ones(4, 2)))
    named.append(("embed_scalar", torch.tensor(1.0)))
    dense, sparse = SP.split_sparse_leaves(named, ("embed",))
    assert [i for i, _, _ in sparse] == [1]
    assert [n for _, n, _ in sparse] == ["embed"]
    assert dense[1] is None and dense[-1] is named[-1][1]
    merged = SP.merge_sparse_leaves(dense, [(1, named[1][1] * 2)])
    assert len(merged) == len(named)
    for (n, t), m in zip(named, merged):
        assert torch.equal(m, t * 2 if n == "embed" else t), n


def test_optimizer_argument_errors(size_one):
    tcfg = T.TransformerConfig(**CFG, dtype=torch.float32)
    p = _torch_params(_jax_params(JT.TransformerConfig(
        **CFG, dtype=jnp.float32)), tcfg)
    with pytest.raises(ValueError, match="sparse_keys needs named"):
        optim.DistributedOptimizer(_adamw(p), sparse_keys=("embed",))
    with pytest.raises(ValueError, match="Unknown reduce op"):
        optim.DistributedOptimizer(_adamw(p), op="Mean")
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        optim.DistributedAdasumOptimizer(_adamw(p),
                                         backward_passes_per_step=0)
    assert not optim.DistributedAdasumOptimizer(_adamw(p)).graph_safe
    assert not optim.DistributedOptimizer(_adamw(p), op="Adasum").graph_safe
    assert optim.DistributedOptimizer(_adamw(p)).graph_safe


# --- 3. four gloo processes against the JAX package ---------------------------


CASES = ("adasum_op", "adasum_delta_k1", "adasum_delta_k2", "sparse_keys",
         "accumulate_k2", "hierarchical")

_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from horovod_tpu_torch import basics, optim, spmd
    from horovod_tpu_torch.models import params_from_jax
    from horovod_tpu_torch.models import transformer as T

    inp, out = sys.argv[1], sys.argv[2]
    basics.init(device="cpu")
    r, n = basics.rank(), basics.size()
    d = np.load(inp)
    cfg = T.TransformerConfig(**json.loads(str(d["cfg"])),
                              dtype=torch.float32, attention_impl="reference")
    tree = {"layers": {}}
    for name in d.files:
        if name.startswith("p."):
            key = name[2:]
            if key.startswith("layers."):
                tree["layers"][key[7:]] = d[name]
            else:
                tree[key] = d[name]

    def params():
        p = params_from_jax(tree, cfg, device="cpu",
                            param_dtype=torch.float32)
        for _, t in optim.named_parameters(p):
            t.requires_grad_()
        return p

    def batch(i):
        rows = d["tokens"].shape[1] // n
        return {k: torch.from_numpy(d[k][i][r * rows:(r + 1) * rows]).long()
                for k in ("tokens", "targets")}

    def adamw(p):
        return torch.optim.AdamW([t for _, t in optim.named_parameters(p)],
                                 lr=float(d["lr"]), betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)

    def loss(p, b):
        return T.loss_fn(p, b, cfg)

    res = {}

    def snap(key, p):
        for name, t in optim.named_parameters(p):
            res[f"{key}.{name}"] = t.detach().numpy().copy()

    for case in ("adasum_op", "adasum_delta_k1", "adasum_delta_k2",
                 "sparse_keys", "accumulate_k2", "hierarchical"):
        p = params()
        named = optim.named_parameters(p)
        if case == "adasum_op":
            opt = optim.DistributedOptimizer(adamw(p), op="Adasum")
        elif case.startswith("adasum_delta"):
            opt = optim.DistributedAdasumOptimizer(
                adamw(p), backward_passes_per_step=int(case[-1]))
        elif case == "sparse_keys":
            opt = optim.DistributedOptimizer(adamw(p), named_parameters=named,
                                             sparse_keys=("embed",))
        elif case == "accumulate_k2":
            opt = optim.DistributedOptimizer(adamw(p),
                                             backward_passes_per_step=2)
        else:
            opt = optim.DistributedOptimizer(adamw(p))
        step = spmd.make_train_step(loss, opt,
                                    hierarchical=case == "hierarchical")
        losses = []
        for i in range(d["tokens"].shape[0]):
            losses.append(float(step(p, batch(i))))
            if case == "accumulate_k2":
                snap(f"{case}.{i}", p)
        res[f"{case}.losses"] = np.asarray(losses)
        snap(case, p)

    # The tape: the first batch's value and reduced gradients.
    p = params()
    tape = optim.DistributedGradientTape(loss)
    value, grads = tape(p, batch(0))
    res["tape.value"] = np.asarray(float(value))
    for name, g in optim.named_parameters(grads):
        res[f"tape.{name}"] = g.numpy()
    basics.shutdown()
    np.savez(out.replace(".npz", f".{r}.npz"), **res)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_cases(jparams, jcfg, batches):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:N]), ("w",))

    def loss(p, b):
        return JT.loss_fn(p, b, jcfg)

    adamw = optax.adamw(LR)
    opts = {
        "adasum_op": JO.DistributedOptimizer(adamw, op=JC.Adasum,
                                             axis_name="w"),
        "adasum_delta_k1": JO.DistributedAdasumOptimizer(adamw,
                                                         axis_name="w"),
        "adasum_delta_k2": JO.DistributedAdasumOptimizer(
            adamw, axis_name="w", backward_passes_per_step=2),
        # In-graph JAX leaves reduce dense; the port's sparse route must
        # give the same parameters.
        "sparse_keys": JO.DistributedOptimizer(adamw, axis_name="w",
                                               sparse_keys=("embed",)),
        "accumulate_k2": JO.DistributedOptimizer(
            adamw, axis_name="w", backward_passes_per_step=2),
    }
    out = {}
    for case, opt in opts.items():
        step = JS.make_train_step(loss, opt, mesh=mesh, axis="w",
                                  donate=False)
        p = jax.tree_util.tree_map(jnp.asarray, jparams)
        state = opt.init(p)
        losses = []
        for i, b in enumerate(batches):
            p, state, l = step(p, state, {k: jnp.asarray(v)
                                          for k, v in b.items()})
            losses.append(float(l))
            if case == "accumulate_k2":
                out.update({f"{case}.{i}.{k}": v
                            for k, v in _flat(p).items()})
        out[f"{case}.losses"] = np.asarray(losses)
        out.update({f"{case}.{k}": v for k, v in _flat(p).items()})
    # The port's two-level step (2 hosts x 2 ranks) against the flat JAX
    # step: the same sums in another order.
    out.update({k.replace("sparse_keys.", "hierarchical.", 1): v
                for k, v in out.items() if k.startswith("sparse_keys.")})

    def tape_fn(p, b):
        value, grads = JO.DistributedGradientTape(loss, axis_name="w")(p, b)
        return value[None], grads

    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    value, grads = jax.jit(JS.shard(
        tape_fn, in_specs=(jax.sharding.PartitionSpec(),
                           jax.sharding.PartitionSpec("w")),
        out_specs=(jax.sharding.PartitionSpec("w"),
                   jax.sharding.PartitionSpec()), mesh=mesh))(
        jax.tree_util.tree_map(jnp.asarray, jparams), b0)
    out["tape.values"] = np.asarray(value)
    out.update({f"tape.{k}": v for k, v in _flat(grads).items()})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    jcfg = JT.TransformerConfig(**CFG, dtype=jnp.float32,
                                attention_impl="reference")
    jparams = _jax_params(jcfg)
    batches = [_batch(20 + i, N * ROWS) for i in range(STEPS + 1)]
    tmp = tmp_path_factory.mktemp("training_api")
    inp = tmp / "in.npz"
    np.savez(inp, cfg=json.dumps(CFG), lr=LR,
             tokens=np.stack([b["tokens"] for b in batches]),
             targets=np.stack([b["targets"] for b in batches]),
             **{"p." + k: v for k, v in _flat(jparams).items()})
    port = _free_port()
    procs = []
    for r in range(N):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(r % 2), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   PYTHONPATH=str(REPO))
        for k in ("HOROVOD_HIERARCHICAL_ALLREDUCE",
                  "HOROVOD_HIERARCHICAL_ALLGATHER"):
            env.pop(k, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(inp), str(tmp / "out.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        jx = _jax_cases(jparams, jcfg, batches)  # while the workers run
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * N, "\n".join(logs)
    return jx, [dict(np.load(tmp / f"out.{r}.npz")) for r in range(N)], \
        list(_flat(jparams))


@pytest.mark.parametrize("case", CASES)
def test_optimizer_matches_jax(results, case):
    """Four steps from the same parameters: the losses and every
    parameter equal the JAX step's, and every rank holds the same
    parameters."""
    jx, port, names = results
    tol = DELTA_TOL if case.startswith("adasum_delta") else TOL
    for r in range(N):
        np.testing.assert_allclose(port[r][f"{case}.losses"],
                                   jx[f"{case}.losses"], **TOL)
        for name in names:
            key = f"{case}.{name}"
            np.testing.assert_allclose(port[r][key], jx[key], **tol,
                                       err_msg=f"rank {r} {key}")
            np.testing.assert_array_equal(port[r][key], port[0][key])


@pytest.mark.parametrize("call", range(STEPS + 1))
def test_accumulate_and_boundary_passes_match_jax(results, call):
    """``backward_passes_per_step=2``: after an accumulate pass (calls 0
    and 2) the parameters are unchanged; after a boundary pass (1, 3)
    they equal the JAX ``_AccumState`` step's."""
    jx, port, names = results
    for name in names:
        key = f"accumulate_k2.{call}.{name}"
        np.testing.assert_allclose(port[0][key], jx[key], **TOL,
                                   err_msg=key)
        if call % 2 == 0:
            before = (port[0][f"accumulate_k2.{call - 1}.{name}"]
                      if call else None)
            if before is not None:
                np.testing.assert_array_equal(port[0][key], before)


def test_gradient_tape_matches_jax(results):
    jx, port, names = results
    for r in range(N):
        np.testing.assert_allclose(port[r]["tape.value"],
                                   jx["tape.values"][r], **TOL)
        for name in names:
            np.testing.assert_allclose(port[r][f"tape.{name}"],
                                       jx[f"tape.{name}"], **TOL,
                                       err_msg=name)
