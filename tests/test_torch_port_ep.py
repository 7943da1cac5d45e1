"""horovod_tpu_torch's model-level expert parallelism against the JAX
package, on the CPU: ``TransformerConfig(moe_axis="ep")`` over the bound
mesh's ``ep`` axis, ``spmd.make_train_step(mesh=, axis=)`` with
``DistributedOptimizer(axis_name=)``, and ``make_gspmd_train_step`` over
an ``ep`` axis of size 2.

One job of four gloo processes (an inline worker that imports only the
port) runs every case once and writes each rank's results to an
``.npz``; the parent holds them, one named test a case, against the JAX
package on four of the conftest's virtual CPU devices, computed while
the workers run: the loss under ``shard_map`` over the JAX package's
``make_mesh`` with the resident experts sliced as
``tests/test_pipeline.py``'s ``_ep_shard_params`` does (the parameters
replicated, rank e's slice ``[e*E_loc, (e+1)*E_loc)`` of the expert
stacks), its ``make_train_step`` with ``DistributedOptimizer(optax.adamw,
axis_name="ep")``, and its ``make_gspmd_train_step``.  Both sides take
the JAX package's ``init_params`` and the same seeded numpy tokens, rank
``r`` (device ``r``) rows ``[2r, 2r + 2)``.

Tolerances (the JAX tests'): per-rank losses within 1e-5; per-rank
gradients within ``_assert_grad_trees_match``'s 2e-4 (an expert stack's
gradient is the whole stack's, zero outside the rank's resident slice,
on both sides); the parameters after one AdamW step of the ``ep`` train
step within 1e-5; the GSPMD step's losses at rtol 1e-5 and parameters
at rtol 1e-4 / atol 1e-5 (``tests/test_torch_port_gspmd.py``'s).  At
``capacity_factor`` 1.0 below the 4 experts tokens drop; the losses
there must differ from the no-drop case's and still match JAX's.
"""

import json
import os
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
from jax.sharding import PartitionSpec as P

from horovod_tpu import optim as JO
from horovod_tpu import spmd as JS
from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import meshes as JM
from horovod_tpu_torch import basics
from horovod_tpu_torch import parallel
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.models import transformer as T

REPO = Path(__file__).resolve().parents[1]
N = 4
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 2e-4, 1e-5
GSPMD_LOSS_RTOL, GSPMD_PARAM_RTOL, GSPMD_PARAM_ATOL = 1e-5, 1e-4, 1e-5
E = 4
MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=16, n_experts=E)
ROWS = 2 * N  # two rows a rank
EXPERT_KEYS = ("w_gate", "w_up", "w_down")
# name: (mesh axes, capacity factor, dispatch)
CASES = {"ep4": ({"ep": 4}, 4.0, "sort"),
         "ep4.drop": ({"ep": 4}, 1.0, "sort"),
         "ep4.drop.cumsum": ({"ep": 4}, 1.0, "cumsum"),
         "dp2_ep2": ({"dp": 2, "ep": 2}, 4.0, "sort"),
         "dp2_ep2.drop": ({"dp": 2, "ep": 2}, 1.0, "sort")}
STEP = ({"ep": 4}, 4.0)  # the make_train_step case: mesh and capacity
GSPMD = ({"dp": 2, "ep": 2}, 2)  # mesh, steps (SGD 0.1, global batch)
LR, SGD_LR = 3e-4, 0.1


def _inputs():
    rng = np.random.RandomState(0)
    tok = rng.randint(0, MODEL["vocab_size"],
                      (ROWS, MODEL["max_seq"])).astype(np.int32)
    out = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
    for i in range(GSPMD[1]):
        t = rng.randint(0, MODEL["vocab_size"],
                        (4, MODEL["max_seq"])).astype(np.int32)
        out[f"gspmd.tokens.{i}"] = t
        out[f"gspmd.targets.{i}"] = np.roll(t, -1, axis=1)
    return out


def _jcfg(cf=4.0, moe_axis="ep", dispatch="sort"):
    return JT.TransformerConfig(**MODEL, dtype=jnp.float32,
                                capacity_factor=cf, moe_axis=moe_axis,
                                moe_dispatch=dispatch)


def _jax_params():
    return jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.PRNGKey(0), _jcfg()))


def _flat(tree, prefix=""):
    return {prefix + jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed
    torch.set_num_threads(1)
    from horovod_tpu_torch import basics, optim, parallel, spmd
    from horovod_tpu_torch.models import params_from_jax
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.parallel import sharding as SH

    inp, out, store = sys.argv[1], sys.argv[2], sys.argv[3]
    basics.init(device="cpu", init_method=f"file://{store}")
    r, n = basics.rank(), basics.size()
    d = np.load(inp)
    spec = json.loads(str(d["spec"]))
    res = {}

    def put(key, t):
        res[key] = (t.detach().float().numpy().copy() if torch.is_tensor(t)
                    else np.asarray(t))

    def cfg(cf, moe_axis="ep", dispatch="sort"):
        return T.TransformerConfig(**spec["model"], dtype=torch.float32,
                                   capacity_factor=cf, moe_axis=moe_axis,
                                   moe_dispatch=dispatch)

    def params():
        tree = {"layers": {}}
        for name in d.files:
            if name.startswith("p."):
                key = name[2:]
                if key.startswith("layers."):
                    tree["layers"][key[7:]] = d[name]
                else:
                    tree[key] = d[name]
        p = params_from_jax(tree, cfg(4.0), device="cpu",
                            param_dtype=torch.float32)
        for _, t in optim.named_parameters(p):
            t.requires_grad_()
        return p

    def rows():
        return {k: torch.from_numpy(d[k][2 * r:2 * r + 2]).long()
                for k in ("tokens", "targets")}

    for name, (axes, cf, dispatch) in spec["cases"].items():
        mesh = parallel.make_mesh(parallel.MeshSpec(**axes), device="cpu")
        p = params()
        with parallel.bind(mesh):
            loss = T.loss_fn(p, rows(), cfg(cf, dispatch=dispatch))
            loss.backward()
        put(f"{name}.loss", loss)
        for pn, t in optim.named_parameters(p):
            put(f"{name}.grad.{pn}", t.grad)

    axes, cf = spec["step"]
    mesh = parallel.make_mesh(parallel.MeshSpec(**axes), device="cpu")
    p = params()
    named = optim.named_parameters(p)
    opt = optim.DistributedOptimizer(
        torch.optim.AdamW([t for _, t in named], lr=spec["lr"],
                          betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
        named_parameters=named, axis_name="ep")
    c = cfg(cf)
    step = spmd.make_train_step(lambda p, b: T.loss_fn(p, b, c), opt,
                                mesh=mesh, axis="ep")
    put("step.loss", step(p, rows()))
    for pn, t in named:
        put(f"step.{pn}", t)

    axes, steps = spec["gspmd"]
    mesh = parallel.make_mesh(parallel.MeshSpec(**axes), device="cpu")
    c = cfg(4.0, moe_axis=None)
    p = SH.distribute(params(), SH.named_shardings(mesh, T.param_specs(c)))
    ts = [t for _, t in optim.named_parameters(p)]
    for t in ts:
        t.requires_grad_()
    step = spmd.make_gspmd_train_step(
        lambda p, b: T.loss_fn(p, b, c), torch.optim.SGD(ts, lr=spec["sgd"]),
        mesh=mesh, param_spec=T.param_specs(c), batch_spec=T.batch_specs())
    put("gspmd.losses", [float(step(p, {
        k: torch.from_numpy(d[f"gspmd.{k}.{i}"]).long()
        for k in ("tokens", "targets")})) for i in range(steps)])
    for pn, t in optim.named_parameters(p):
        put(f"gspmd.{pn}", SH.full(t))
    # Every rank past its last exchange before any tears down.
    torch.distributed.barrier()
    basics.shutdown()
    np.savez(f"{out}.{r}.npz", **res)
""")


def _start_workers(tmp, inputs, jparams):
    spec = {"model": MODEL, "cases": CASES, "step": STEP, "gspmd": GSPMD,
            "lr": LR, "sgd": SGD_LR}
    np.savez(tmp / "in.npz", spec=json.dumps(spec), **inputs,
             **_flat(jparams, "p."))
    procs = []
    for r in range(N):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(N),
                   HOROVOD_NATIVE="0", PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp / "in.npz"),
             str(tmp / "out"), str(tmp / "store")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs, tmp):
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * N, "\n".join(logs)
    return [dict(np.load(tmp / f"out.{r}.npz")) for r in range(N)]


# --- the JAX side ------------------------------------------------------------


def _mesh(axes):
    return JM.make_mesh(JM.MeshSpec(**axes), jax.devices()[:N])


def _ep_shard_params(pr, ep):
    """``tests/test_pipeline.py``'s: this device's resident experts out of
    the replicated stacks (experts on axis 1 of ``(L, E, ...)``)."""
    e = jax.lax.axis_index("ep")
    e_loc = E // ep
    return {**pr, "layers": {
        k: (jax.lax.dynamic_slice_in_dim(v, e * e_loc, e_loc, 1)
            if k in EXPERT_KEYS else v)
        for k, v in pr["layers"].items()}}


def _rows_spec(axes):
    names = tuple(a for a in JM.AXIS_ORDER if a in axes)
    return P(names if len(names) > 1 else names[0])


def _jax_case(jparams, inputs, axes, cf, dispatch):
    """Per-device losses and gradients of the loss with the resident
    experts sliced, under ``shard_map`` (``check_vma=False``, as the
    composition worker runs it); the gradients are of the whole
    replicated parameters, zero outside the resident slices."""
    cfg = _jcfg(cf, dispatch=dispatch)
    ep = axes["ep"]

    def inner(params, b):
        def loss(p):
            return JT.loss_fn(_ep_shard_params(p, ep), b, cfg)

        l, g = jax.value_and_grad(loss)(params)
        return l[None], jax.tree_util.tree_map(lambda x: x[None], g)

    every = P(JM.AXIS_ORDER)
    rows = _rows_spec(axes)
    fn = jax.jit(jax.shard_map(
        inner, mesh=_mesh(axes), in_specs=(P(), {"tokens": rows,
                                                 "targets": rows}),
        out_specs=(every, every), check_vma=False))
    b = {k: jnp.asarray(inputs[k]) for k in ("tokens", "targets")}
    l, g = fn(jax.tree_util.tree_map(jnp.asarray, jparams), b)
    return np.asarray(l), _flat(g)


def _jax_step(jparams, inputs):
    """JAX's ``make_train_step(mesh=, axis="ep")`` with
    ``DistributedOptimizer(optax.adamw, axis_name="ep")``, one step."""
    axes, cf = STEP
    cfg = _jcfg(cf)
    mesh = _mesh(axes)
    opt = JO.DistributedOptimizer(optax.adamw(LR), axis_name="ep")
    step = JS.make_train_step(
        lambda p, b: JT.loss_fn(_ep_shard_params(p, axes["ep"]), b, cfg), opt,
        mesh=mesh, axis="ep", donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    b = {k: jnp.asarray(inputs[k]) for k in ("tokens", "targets")}
    new, _, loss = step(params, opt.init(params), b)
    return float(loss), _flat(new)


def _jax_gspmd(jparams, inputs):
    axes, steps = GSPMD
    cfg = _jcfg(4.0, moe_axis=None)
    opt = optax.sgd(SGD_LR)
    step = JS.make_gspmd_train_step(
        lambda p, b: JT.loss_fn(p, b, cfg), opt, mesh=_mesh(axes),
        param_spec=JT.param_specs(cfg), batch_spec=JT.batch_specs(),
        donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    state = opt.init(params)
    losses = []
    for i in range(steps):
        b = {k: jnp.asarray(inputs[f"gspmd.{k}.{i}"])
             for k in ("tokens", "targets")}
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
    return np.asarray(losses), _flat(params)


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    """The four gloo ranks' results, and the JAX side computed while the
    workers run."""
    tmp = tmp_path_factory.mktemp("ep")
    inputs = _inputs()
    jparams = _jax_params()
    procs = _start_workers(tmp, inputs, jparams)
    try:
        cases = {name: _jax_case(jparams, inputs, *case)
                 for name, case in CASES.items()}
        step = _jax_step(jparams, inputs)
        gspmd = _jax_gspmd(jparams, inputs)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return {"ranks": _wait(procs, tmp), "cases": cases, "step": step,
            "gspmd": gspmd}


def _by_rank(ep, key):
    return np.stack([r[key] for r in ep["ranks"]])


# --- moe_axis over the bound mesh --------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_per_rank_loss_matches_jax(ep, case):
    jloss, _ = ep["cases"][case]
    np.testing.assert_allclose(_by_rank(ep, f"{case}.loss"), jloss,
                               atol=LOSS_TOL, rtol=LOSS_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_per_rank_gradients_match_jax(ep, case):
    """Every parameter's gradient on every rank; an expert stack's is zero
    outside the rank's resident slice on both sides."""
    axes, _, _ = CASES[case]
    _, jgrads = ep["cases"][case]
    got = {k[len(case) + 6:]: _by_rank(ep, k) for k in ep["ranks"][0]
           if k.startswith(f"{case}.grad.")}
    assert set(got) == set(jgrads)
    e_loc = E // axes["ep"]
    for name, want in jgrads.items():
        np.testing.assert_allclose(got[name], want, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)
        if name.split(".")[-1] in EXPERT_KEYS:
            for r in range(N):
                e = r % axes["ep"]
                outside = np.delete(got[name][r], np.s_[
                    e * e_loc:(e + 1) * e_loc], axis=1)
                assert not outside.any(), (name, r)


def test_capacity_drops_tokens(ep):
    """At ``capacity_factor`` 1.0 the switch dispatch drops tokens (the
    losses move off the no-drop case's) and the two dispatches agree."""
    for mesh in ("ep4", "dp2_ep2"):
        full = _by_rank(ep, f"{mesh}.loss")
        drop = _by_rank(ep, f"{mesh}.drop.loss")
        assert np.abs(full - drop).max() > 1e-4, mesh
    np.testing.assert_allclose(_by_rank(ep, "ep4.drop.cumsum.loss"),
                               _by_rank(ep, "ep4.drop.loss"), rtol=1e-6)


def test_train_step_over_ep_matches_jax(ep):
    """``make_train_step(mesh=, axis="ep")`` with
    ``DistributedOptimizer(axis_name="ep")``: the loss averaged over ep
    and every parameter after one AdamW step, on every rank."""
    jloss, jparams = ep["step"]
    for rank in ep["ranks"]:
        np.testing.assert_allclose(rank["step.loss"], jloss, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        for name, want in jparams.items():
            np.testing.assert_allclose(rank[f"step.{name}"], want,
                                       atol=PARAM_TOL, rtol=PARAM_TOL,
                                       err_msg=name)


def test_gspmd_step_over_ep_matches_jax(ep):
    """``make_gspmd_train_step`` at dp 2 x ep 2 (the expert stacks
    sharded over ep): two SGD steps' losses and the parameters after."""
    jlosses, jparams = ep["gspmd"]
    for rank in ep["ranks"]:
        np.testing.assert_allclose(rank["gspmd.losses"], jlosses,
                                   rtol=GSPMD_LOSS_RTOL)
        for name, want in jparams.items():
            np.testing.assert_allclose(rank[f"gspmd.{name}"], want,
                                       rtol=GSPMD_PARAM_RTOL,
                                       atol=GSPMD_PARAM_ATOL, err_msg=name)


# --- in one process ----------------------------------------------------------


def _port_params(cfg):
    p = params_from_jax(_jax_params(), cfg, device="cpu",
                        param_dtype=torch.float32)
    leaves = [p["embed"], p["head"], p["ln_f"], *p["layers"].values()]
    for t in leaves:
        t.requires_grad_()
    return p, leaves


def test_unbound_moe_axis_raises():
    cfg = T.TransformerConfig(**MODEL, dtype=torch.float32, moe_axis="ep")
    p, _ = _port_params(cfg)
    tok = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NameError, match="unbound axis name: ep"):
        T.loss_fn(p, {"tokens": tok, "targets": tok}, cfg)


def test_size_one_equals_no_axis():
    """At ep = 1 the resident slice is every expert and the exchange is
    over one rank: loss and every gradient bit-equal to ``moe_axis=None``
    (the chip script's MoE leg at full width)."""
    inputs = _inputs()
    b = {k: torch.from_numpy(inputs[k]).long() for k in ("tokens",
                                                         "targets")}
    out = {}
    torch.manual_seed(0)
    basics.init(device="cpu")
    try:
        with parallel.bind(parallel.make_mesh(parallel.MeshSpec(),
                                              device="cpu")):
            for axis in (None, "ep"):
                cfg = T.TransformerConfig(**MODEL, dtype=torch.float32,
                                          capacity_factor=1.0,
                                          moe_axis=axis)
                p, leaves = _port_params(cfg)
                loss = T.loss_fn(p, b, cfg)
                loss.backward()
                out[axis] = [loss.detach()] + [t.grad for t in leaves]
    finally:
        basics.shutdown()
    assert all(torch.equal(a, b) for a, b in zip(out[None], out["ep"]))


def test_config_with_moe_axis_constructs_like_jax():
    kw = dict(MODEL, moe_axis="ep")
    assert T.TransformerConfig(**kw).moe_axis == \
        JT.TransformerConfig(**kw).moe_axis == "ep"
