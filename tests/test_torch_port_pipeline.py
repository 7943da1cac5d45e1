"""horovod_tpu_torch's pipeline parallelism against the JAX package, on
the CPU: ``parallel.pipeline`` (``pipeline_apply``, ``interleaved_apply``
and the three schedules of ``pipeline_value_and_grad`` on JAX's tanh
stage), the model's ``pipelined_forward`` and ``pipelined_value_and_grad``
(GPipe, 1F1B, interleaved; the MoE balance loss), and the compositions
of ``tests/composition_worker.py``: 1F1B x switch MoE over (pp 2, ep 2),
1F1B x ring over (pp 2, sp 2), interleaved x ring, 1F1B x zigzag ring,
and (pp 2, sp 2, ep 2).

One job of eight gloo processes (an inline worker that imports only the
port) runs every case once, each rank writing its results to an
``.npz``; the parent holds them, one named test a case, against the JAX
package, computed while the workers run.  The P = 4 cases run over a
mesh of dp 2 x pp 4 (both dp replicas must agree), the compositions over
their mesh with dp filling the eight ranks.  Inputs are seeded numpy
arrays and the JAX package's ``init_params`` / ``synthetic_batch``.

Oracles and tolerances, JAX's own (``tests/test_pipeline.py``): the
tanh stage's outputs against JAX's ``pipeline_apply`` /
``interleaved_apply`` under ``shard_map`` and the sequential oracle at
1e-5; its schedules' losses at rtol 1e-5 and every gradient (stage,
loss parameters, inputs) at 1e-5 against ``jax.value_and_grad`` of the
sequential loss (1e-4 for the gradients through ``pipeline_apply``);
the model's logits against JAX's ``pipelined_forward`` at 1e-4; the
model's loss at atol 1e-5 and every gradient at 2e-4
(``_assert_grad_trees_match``) against the single-device
``jax.value_and_grad(loss_fn)``; a composition's loss and gradients,
averaged over the ranks as the composition worker's ``pmean`` over its
data axes (an expert stack's average over ep is JAX's ``psum / ep`` of
the resident pieces), against the unsharded reference at the same
tolerances.  ``_virtual_pipeline`` (every stage in one process) must
equal the gloo pipeline bit for bit.
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
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import pipeline as JP
from horovod_tpu_torch import basics
from horovod_tpu_torch import parallel
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.parallel import pipeline as PL

REPO = Path(__file__).resolve().parents[1]
N, PP = 8, 4
FWD_TOL, APPLY_GRAD_TOL, SCHED_TOL = 1e-5, 1e-4, 1e-5
MODEL_FWD_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 2e-4
D, MB = 8, 2  # the tanh stage: width, rows a microbatch
AUX_W = 0.1
# The tanh stage's pipeline_apply / interleaved_apply cases: (n_virtual or
# None for pipeline_apply, layers, microbatches).
APPLY = {"gpipe.m4": (None, 8, 4), "gpipe.m5": (None, 8, 5),
         "interleaved.v2": (2, 8, 4), "interleaved.v1": (1, 4, 8)}
# Its pipeline_value_and_grad cases: (schedule, microbatches, extras),
# extras "lp_xg" (loss_params and input gradients), "aux" or "".
SCHED = {f"{s}.{e or 'plain'}": (s, 4 if s == "interleaved" else 6, e)
         for s in ("gpipe", "1f1b", "interleaved")
         for e in ("", "lp_xg", "aux")}
MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=8, d_ff=64,
             max_seq=16)
MOE = dict(MODEL, n_experts=4, capacity_factor=4.0, moe_aux_coeff=0.02)
SCHEDULES = ("gpipe", "1f1b", "interleaved")
# The compositions: (mesh axes, schedule, attention, experts, rows).
COMPOSITIONS = {
    "pp_ep": ({"dp": 2, "pp": 2, "ep": 2}, "1f1b", "reference", 4, 8),
    "pp_sp": ({"dp": 2, "pp": 2, "sp": 2}, "1f1b", "ring", 0, 4),
    "pp_sp_interleaved": ({"dp": 2, "pp": 2, "sp": 2}, "interleaved",
                          "ring", 0, 4),
    "pp_sp_zigzag": ({"dp": 2, "pp": 2, "sp": 2}, "1f1b", "ring_zigzag",
                     0, 4),
    "pp_sp_ep": ({"pp": 2, "ep": 2, "sp": 2}, "1f1b", "ring", 4, 4),
}
COMP = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
            max_seq=16, n_kv_heads=2)


def _comp_cfg(name, jax_side=True):
    _, _, attn, E, _ = COMPOSITIONS[name]
    kw = dict(COMP, n_experts=E, capacity_factor=float(max(E, 1)),
              moe_impl="switch")
    if jax_side:  # the unsharded reference's
        return JT.TransformerConfig(**kw, dtype=jnp.float32)
    return dict(kw, moe_axis="ep" if E else None, attention_impl=attn)


def _inputs():
    rng = np.random.RandomState(0)
    out = {}
    for name, (v, layers, m) in APPLY.items():
        out[f"apply.{name}.w"] = (rng.randn(layers, 16, 16)
                                  * (0.5 / np.sqrt(16))).astype(np.float32)
        out[f"apply.{name}.x"] = rng.randn(m, 3, 16).astype(np.float32)
    for name, (_, m, _) in SCHED.items():
        out[f"sched.{name}.w"] = (rng.randn(8, D, D) * 0.3).astype(
            np.float32)
        out[f"sched.{name}.x"] = rng.randn(m, MB, D).astype(np.float32)
        out[f"sched.{name}.t"] = (rng.randn(m, MB, D) * 0.1).astype(
            np.float32)
        out[f"sched.{name}.head"] = (rng.randn(D, D) * 0.5).astype(
            np.float32)
    return out


def _flat(tree, prefix):
    return {prefix + jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _model_inputs():
    """The JAX package's weights and batches: the P = 4 model (seed 0,
    ``synthetic_batch(1, cfg, 4)`` as ``TestPipelinedTransformerAPI``),
    its MoE twin, and the compositions' (``composition_worker.py``'s)."""
    out = {}
    for name, kw in (("dense", MODEL), ("moe", MOE)):
        cfg = JT.TransformerConfig(**kw, dtype=jnp.float32)
        out.update(_flat(JT.init_params(jax.random.PRNGKey(0), cfg),
                         f"p.{name}."))
    out.update(_flat(JT.synthetic_batch(1, JT.TransformerConfig(
        **MODEL, dtype=jnp.float32), batch=4), "batch.model."))
    for name in COMPOSITIONS:
        cfg = _comp_cfg(name)
        out.update(_flat(JT.init_params(jax.random.PRNGKey(0), cfg),
                         f"p.{name}."))
        out.update(_flat(JT.synthetic_batch(0, cfg, batch=COMPOSITIONS[
            name][4]), f"batch.{name}."))
    return out


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed
    torch.set_num_threads(1)
    from horovod_tpu_torch import basics, optim, parallel
    from horovod_tpu_torch.models import params_from_jax
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.parallel import pipeline as PL

    inp, out, store = sys.argv[1], sys.argv[2], sys.argv[3]
    basics.init(device="cpu", init_method=f"file://{store}")
    r, n = basics.rank(), basics.size()
    d = np.load(inp)
    spec = json.loads(str(d["spec"]))
    res = {}

    def put(key, t):
        res[key] = (t.detach().float().numpy().copy() if torch.is_tensor(t)
                    else np.asarray(t))

    def arr(key):
        return torch.from_numpy(d[key])

    def stage_fn(ws, h):
        for i in range(ws.shape[0]):
            h = torch.tanh(h @ ws[i])
        return h

    def aux_stage_fn(ws, h):
        a = torch.zeros(())
        for i in range(ws.shape[0]):
            h = torch.tanh(h @ ws[i])
            a = a + (h * h).mean()
        return h, a

    def sq_loss(y, t):
        return ((y - t) ** 2).sum()

    def head_loss(lp, y, t):
        return ((y @ lp["head"] - t) ** 2).sum()

    PP = spec["pp"]

    def stage_params(w, schedule, v, s):
        if schedule == "interleaved":
            return PL.stack_to_chunks(w, PP, v, s)
        return PL.stack_to_stages(w, PP)[s]

    def sched_args(name):
        schedule, m, extra = spec["sched"][name]
        fn = aux_stage_fn if extra == "aux" else stage_fn
        lp = {"head": arr(f"sched.{name}.head")} if extra == "lp_xg" else None
        kw = dict(schedule=schedule, loss_params=lp,
                  return_input_grads=extra == "lp_xg",
                  aux_weight=spec["aux_w"] if extra == "aux" else None,
                  n_virtual=2)
        return (fn, arr(f"sched.{name}.x"), arr(f"sched.{name}.t"),
                head_loss if lp is not None else sq_loss, kw)

    def put_sched(prefix, out):
        put(f"{prefix}.loss", out[0])
        put(f"{prefix}.gw", out[1])
        extras = out[2] if len(out) > 2 else {}
        if "loss_param_grads" in extras:
            put(f"{prefix}.glp", extras["loss_param_grads"]["head"])
        if "input_grads" in extras:
            put(f"{prefix}.gx", extras["input_grads"])

    def params(name, cfg):
        tree = {"layers": {}}
        pre = f"p.{name}."
        for key in d.files:
            if key.startswith(pre):
                k = key[len(pre):]
                if k.startswith("layers."):
                    tree["layers"][k[7:]] = d[key]
                else:
                    tree[k] = d[key]
        return params_from_jax(tree, cfg, device="cpu",
                               param_dtype=torch.float32)

    def batch(name):
        return {k: torch.from_numpy(d[f"batch.{name}.{k}"]).long()
                for k in ("tokens", "targets")}

    def put_model(prefix, loss, grads):
        put(f"{prefix}.loss", loss)
        for pn, t in optim.named_parameters(grads):
            put(f"{prefix}.grad.{pn}", t)

    mesh = parallel.make_mesh(parallel.MeshSpec(dp=n // PP, pp=PP),
                              device="cpu")
    with parallel.bind(mesh):
        g, s = parallel.axis_group("pp"), parallel.axis_index("pp")
        put("pp_index", s)
        # The tanh stage: pipeline_apply / interleaved_apply, forward and
        # gradients of sum(out ** 2).
        for name, (v, layers, m) in spec["apply"].items():
            w = arr(f"apply.{name}.w")
            x = arr(f"apply.{name}.x").requires_grad_()
            sp_ = (PL.stack_to_stages(w, PP)[s] if v is None
                   else PL.stack_to_chunks(w, PP, v, s)).requires_grad_()
            if v is None:
                o = PL.pipeline_apply(stage_fn, sp_, x, group=g)
            else:
                o = PL.interleaved_apply(stage_fn, sp_, x, group=g,
                                         n_virtual=v)
            (o ** 2).sum().backward()
            put(f"apply.{name}.out", o)
            put(f"apply.{name}.gw", sp_.grad)
            put(f"apply.{name}.gx", x.grad)
        o, a = PL.pipeline_apply(aux_stage_fn, PL.stack_to_stages(
            arr("apply.gpipe.m4.w"), PP)[s], arr("apply.gpipe.m4.x"),
            group=g, stage_aux=True)
        put("apply.aux.out", o)
        put("apply.aux.aux", a)
        # Its schedules, and their virtual twins on rank 0.
        for name, (schedule, m, extra) in spec["sched"].items():
            fn, x, t, lf, kw = sched_args(name)
            w = arr(f"sched.{name}.w")
            put_sched(f"sched.{name}", PL.pipeline_value_and_grad(
                fn, stage_params(w, schedule, 2, s), x, t, lf, group=g,
                **kw))
            if r == 0:
                outs = PL._virtual_pipeline(
                    fn, [stage_params(w, schedule, 2, q) for q in range(PP)],
                    x, t, lf, **kw)
                for q, o in enumerate(outs):
                    put_sched(f"virtual.sched.{name}.{q}", o)
        # The model.
        cfg = T.TransformerConfig(**spec["model"], dtype=torch.float32)
        p = params("dense", cfg)
        b = batch("model")
        put("model.forward", T.pipelined_forward(p, b["tokens"], cfg))
        for schedule in spec["schedules"]:
            put_model(f"model.{schedule}", *T.pipelined_value_and_grad(
                p, b, cfg, schedule=schedule))
            if r == 0:
                put_model(f"virtual.model.{schedule}",
                          *T._pipelined_value_and_grad(
                              p, b, cfg, PL._Stages.virtual(PP),
                              schedule=schedule))
        cfg = T.TransformerConfig(**spec["moe"], dtype=torch.float32)
        p = params("moe", cfg)
        for schedule in ("gpipe", "1f1b"):
            put_model(f"moe.m1.{schedule}", *T.pipelined_value_and_grad(
                p, b, cfg, schedule=schedule, n_microbatches=1))
        for schedule in spec["schedules"]:
            put_model(f"moe.m4.{schedule}", *T.pipelined_value_and_grad(
                p, b, cfg, schedule=schedule, n_microbatches=4))
        import dataclasses
        put_model("moe.m4.noaux", *T.pipelined_value_and_grad(
            p, b, dataclasses.replace(cfg, moe_aux_coeff=0.0),
            schedule="1f1b", n_microbatches=4))

    # The compositions.
    for name, (axes, schedule, attn, E, rows) in spec["comp"].items():
        cmesh = parallel.make_mesh(parallel.MeshSpec(**axes), device="cpu")
        cfg = T.TransformerConfig(**spec["comp_cfg"][name],
                                  dtype=torch.float32)
        p = params(name, cfg)
        b = batch(name)
        with parallel.bind(cmesh):
            ep_n = parallel.axis_size("ep")
            ep_i = parallel.axis_index("ep")
            sp_n = parallel.axis_size("sp")
            sp_i = parallel.axis_index("sp")
            S = b["tokens"].shape[1]
            cols = (torch.as_tensor(A.zigzag_perm(S, sp_n)[0])
                    if attn == "ring_zigzag" else torch.arange(S))
            per_r, per_s = b["tokens"].shape[0] // ep_n, S // sp_n
            shard = {k: v[ep_i * per_r:(ep_i + 1) * per_r][
                :, cols[sp_i * per_s:(sp_i + 1) * per_s]]
                for k, v in b.items()}
            put_model(f"comp.{name}", *T.pipelined_value_and_grad(
                p, shard, cfg, schedule=schedule, n_virtual=2))
    # Every rank past its last exchange before any tears down.
    torch.distributed.barrier()
    basics.shutdown()
    np.savez(f"{out}.{r}.npz", **res)
""")


def _start_workers(tmp, inputs):
    spec = {"pp": PP, "apply": APPLY, "sched": SCHED, "aux_w": AUX_W,
            "model": MODEL, "moe": MOE, "schedules": SCHEDULES,
            "comp": COMPOSITIONS,
            "comp_cfg": {name: _comp_cfg(name, False)
                         for name in COMPOSITIONS}}
    np.savez(tmp / "in.npz", spec=json.dumps(spec), **inputs)
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
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * N, "\n".join(logs)
    return [dict(np.load(tmp / f"out.{r}.npz")) for r in range(N)]


# --- the JAX side ------------------------------------------------------------


def _pp_mesh():
    return Mesh(np.array(jax.devices()[:PP]), ("pp",))


def _stage_fn(w_stack, x):
    """``tests/test_pipeline.py``'s stage: a scan of tanh layers."""
    def layer(h, w):
        return jnp.tanh(h @ w), None

    return jax.lax.scan(layer, x, w_stack)[0]


def _aux_stage_fn(w_stack, x):
    def layer(c, w):
        h, a = c
        h = jnp.tanh(h @ w)
        return (h, a + jnp.mean(h * h)), None

    return jax.lax.scan(layer, (x, jnp.float32(0.0)), w_stack)[0]


def _jax_apply(inputs):
    """JAX's ``pipeline_apply`` / ``interleaved_apply`` forward under
    ``shard_map`` over four devices; the sequential oracle's output and
    gradients of ``sum(out ** 2)``."""
    out = {}
    for name, (v, layers, m) in APPLY.items():
        w = jnp.asarray(inputs[f"apply.{name}.w"])
        x = jnp.asarray(inputs[f"apply.{name}.x"])
        if v is None:
            fwd = jax.jit(jax.shard_map(
                lambda wst, xs: JP.pipeline_apply(_stage_fn, wst[0], xs,
                                                  axis_name="pp"),
                mesh=_pp_mesh(), in_specs=(P("pp"), P()), out_specs=P()))
            got = fwd(JP.stack_to_stages(w, PP), x)
        else:
            def inner(w_full, xs, v=v):
                s = jax.lax.axis_index("pp")
                return JP.interleaved_apply(
                    _stage_fn, JP.stack_to_chunks(w_full, PP, v, s), xs,
                    axis_name="pp", n_virtual=v)

            got = jax.jit(jax.shard_map(
                inner, mesh=_pp_mesh(), in_specs=(P(), P()),
                out_specs=P()))(w, x)

        def seq(w, x):
            return jnp.sum(jax.vmap(lambda xb: _stage_fn(w, xb))(x) ** 2)

        ref = jax.vmap(lambda xb: _stage_fn(w, xb))(x)
        gw, gx = jax.grad(seq, argnums=(0, 1))(w, x)
        out[name] = tuple(map(np.asarray, (got, ref, gw, gx)))
    w = jnp.asarray(inputs["apply.gpipe.m4.w"])
    x = jnp.asarray(inputs["apply.gpipe.m4.x"])
    ys, auxs = jax.vmap(lambda xb: _aux_stage_fn(w, xb))(x)
    out["aux"] = (np.asarray(ys), float(jnp.sum(auxs)))
    return out


def _jax_sched(inputs):
    """The sequential oracle of every schedule case: loss and the
    gradients of the layer stack, the head and the inputs."""
    out = {}
    for name, (_, m, extra) in SCHED.items():
        w, x, t, head = (jnp.asarray(inputs[f"sched.{name}.{k}"])
                         for k in ("w", "x", "t", "head"))

        def loss(w, head, x):
            if extra == "aux":
                ys, auxs = jax.vmap(lambda xb: _aux_stage_fn(w, xb))(x)
                return jnp.sum((ys - t) ** 2) + AUX_W * jnp.sum(auxs)
            ys = jax.vmap(lambda xb: _stage_fn(w, xb))(x)
            if extra == "lp_xg":
                return jnp.sum((ys @ head - t) ** 2)
            return jnp.sum((ys - t) ** 2)

        l, g = jax.value_and_grad(loss, argnums=(0, 1, 2))(w, head, x)
        out[name] = (float(l), *map(np.asarray, g))
    return out


def _jax_model(inputs):
    """JAX's sharded ``pipelined_forward`` over four devices, and the
    single-device ``value_and_grad(loss_fn)`` of the P = 4 model, its MoE
    twin and each composition's unsharded reference."""
    def params(name):
        pre = f"p.{name}."
        tree = {"layers": {}}
        for k, v in inputs.items():
            if k.startswith(pre):
                key = k[len(pre):]
                if key.startswith("layers."):
                    tree["layers"][key[7:]] = jnp.asarray(v)
                else:
                    tree[key] = jnp.asarray(v)
        return tree

    def batch(name):
        return {k: jnp.asarray(inputs[f"batch.{name}.{k}"])
                for k in ("tokens", "targets")}

    out = {}
    cfg = JT.TransformerConfig(**MODEL, dtype=jnp.float32)
    b = batch("model")
    out["forward"] = np.asarray(jax.jit(jax.shard_map(
        lambda pr, tk: JT.pipelined_forward(pr, tk, cfg), mesh=_pp_mesh(),
        in_specs=(P(), P()), out_specs=P()))(params("dense"), b["tokens"]))
    refs = {"dense": (cfg, b), "moe": (JT.TransformerConfig(
        **MOE, dtype=jnp.float32), b)}
    for name in COMPOSITIONS:
        refs[name] = (_comp_cfg(name), batch(name))
    for name, (c, bb) in refs.items():
        l, g = jax.jit(jax.value_and_grad(
            lambda pr, bb, c=c: JT.loss_fn(pr, bb, c)))(params(name), bb)
        out[name] = (float(l), _flat(g, ""))
    return out


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    """The eight gloo ranks' results, and the JAX side computed while the
    workers run."""
    tmp = tmp_path_factory.mktemp("pipeline")
    inputs = {**_inputs(), **_model_inputs()}
    procs = _start_workers(tmp, inputs)
    try:
        jax_side = {"apply": _jax_apply(inputs), "sched": _jax_sched(inputs),
                    "model": _jax_model(inputs)}
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return {"ranks": _wait(procs, tmp), **jax_side, "inputs": inputs}


def _stages(pp):
    """The ranks of the first dp replica, by pp stage, after checking the
    second replica agrees with the first bit for bit."""
    ranks = pp["ranks"]
    for r in range(PP):
        assert int(ranks[r]["pp_index"]) == r
        for key, value in ranks[r].items():
            if not key.startswith(("comp.", "virtual.")):
                assert np.array_equal(value, ranks[r + PP][key]), key
    return ranks[:PP]


def _layer_slice(stage, schedule, layers, v=2):
    """The rows of the layer stack that ``stage``'s gradient covers."""
    if schedule != "interleaved":
        per = layers // PP
        return [np.arange(stage * per, (stage + 1) * per)]
    per = layers // (PP * v)
    return [np.arange((c * PP + stage) * per, (c * PP + stage + 1) * per)
            for c in range(v)]


# --- parallel.pipeline on the tanh stage -------------------------------------


@pytest.mark.parametrize("case", list(APPLY))
def test_apply_matches_jax_and_sequential(pp, case):
    """``pipeline_apply`` / ``interleaved_apply``: every rank holds the
    last stage's outputs, equal to JAX's sharded forward and to the
    sequential oracle; the gradients of ``sum(out ** 2)`` backpropagated
    on every rank are each stage's slice of the sequential gradient, the
    input gradient stage 0's."""
    v, layers, _ = APPLY[case]
    got_jax, ref, gw, gx = pp["apply"][case]
    stages = _stages(pp)
    for s, res in enumerate(stages):
        np.testing.assert_allclose(res[f"apply.{case}.out"], got_jax,
                                   atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(res[f"apply.{case}.out"], ref,
                                   atol=FWD_TOL, rtol=FWD_TOL)
        sched = "gpipe" if v is None else "interleaved"
        rows = _layer_slice(s, sched, layers, v or 1)
        want = np.stack([gw[r] for r in rows]) if v else gw[rows[0]]
        np.testing.assert_allclose(res[f"apply.{case}.gw"], want,
                                   atol=APPLY_GRAD_TOL, rtol=APPLY_GRAD_TOL)
        np.testing.assert_allclose(res[f"apply.{case}.gx"],
                                   gx if s == 0 else np.zeros_like(gx),
                                   atol=APPLY_GRAD_TOL, rtol=APPLY_GRAD_TOL)


def test_apply_stage_aux(pp):
    """``stage_aux``: each stage's aux over its real microbatches; their
    sum over the stages is the sequential aux."""
    ys, aux = pp["apply"]["aux"]
    stages = _stages(pp)
    for res in stages:
        np.testing.assert_allclose(res["apply.aux.out"], ys, atol=FWD_TOL,
                                   rtol=FWD_TOL)
    np.testing.assert_allclose(sum(float(r["apply.aux.aux"])
                                   for r in stages), aux, rtol=1e-5)


@pytest.mark.parametrize("case", list(SCHED))
def test_schedule_matches_sequential(pp, case):
    """``pipeline_value_and_grad``: the loss on every rank, each stage's
    gradient, the loss parameters' on the last stage and the inputs' on
    stage 0 (zeros elsewhere), against the sequential oracle."""
    schedule, _, extra = SCHED[case]
    loss, gw, ghead, gx = pp["sched"][case]
    for s, res in enumerate(_stages(pp)):
        pre = f"sched.{case}"
        np.testing.assert_allclose(res[f"{pre}.loss"], loss, rtol=SCHED_TOL)
        rows = _layer_slice(s, schedule, 8)
        want = (np.stack([gw[r] for r in rows]) if schedule == "interleaved"
                else gw[rows[0]])
        np.testing.assert_allclose(res[f"{pre}.gw"], want, atol=SCHED_TOL,
                                   rtol=SCHED_TOL)
        if extra == "lp_xg":
            np.testing.assert_allclose(
                res[f"{pre}.glp"],
                ghead if s == PP - 1 else np.zeros_like(ghead),
                atol=SCHED_TOL, rtol=SCHED_TOL)
            np.testing.assert_allclose(
                res[f"{pre}.gx"], gx if s == 0 else np.zeros_like(gx),
                atol=SCHED_TOL, rtol=SCHED_TOL)
        else:
            assert f"{pre}.glp" not in res and f"{pre}.gx" not in res


@pytest.mark.parametrize("case", list(SCHED))
def test_virtual_pipeline_equals_gloo_bit_for_bit(pp, case):
    rank0 = pp["ranks"][0]
    for s, res in enumerate(_stages(pp)):
        for part in ("loss", "gw", "glp", "gx"):
            if f"sched.{case}.{part}" in res:
                assert np.array_equal(
                    rank0[f"virtual.sched.{case}.{s}.{part}"],
                    res[f"sched.{case}.{part}"]), (part, s)


# --- the model ---------------------------------------------------------------


def _grads(res, prefix):
    pre = f"{prefix}.grad."
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_pipelined_forward_matches_jax(pp):
    for res in _stages(pp):
        np.testing.assert_allclose(res["model.forward"],
                                   pp["model"]["forward"],
                                   atol=MODEL_FWD_TOL, rtol=MODEL_FWD_TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pipelined_value_and_grad_matches_loss_fn(pp, schedule):
    """The loss and EVERY gradient (embedding, layers, final norm, head),
    the same on every rank, against ``jax.value_and_grad(loss_fn)``."""
    loss, grads = pp["model"]["dense"]
    for res in _stages(pp):
        np.testing.assert_allclose(res[f"model.{schedule}.loss"], loss,
                                   atol=LOSS_TOL)
        _assert_grads(_grads(res, f"model.{schedule}"), grads)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_model_virtual_pipeline_equals_gloo_bit_for_bit(pp, schedule):
    rank0 = pp["ranks"][0]
    want = _grads(rank0, f"virtual.model.{schedule}")
    assert want
    for res in _stages(pp):
        assert np.array_equal(res[f"model.{schedule}.loss"],
                              rank0[f"virtual.model.{schedule}.loss"])
        got = _grads(res, f"model.{schedule}")
        assert set(got) == set(want)
        for name in want:
            assert np.array_equal(got[name], want[name]), name


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_moe_aux_exact_at_one_microbatch(pp, schedule):
    """One microbatch: the pipelined dispatch group is the whole batch,
    so the aux-bearing loss and every gradient (the router's included)
    equal ``jax.value_and_grad(loss_fn)``'s."""
    loss, grads = pp["model"]["moe"]
    for res in _stages(pp):
        np.testing.assert_allclose(res[f"moe.m1.{schedule}.loss"], loss,
                                   atol=LOSS_TOL)
        _assert_grads(_grads(res, f"moe.m1.{schedule}"), grads)


def test_moe_aux_schedules_agree_and_reach_router(pp):
    """Four microbatches: the aux is per dispatch group, and the three
    schedules agree with each other; the aux term moves the router's
    gradient."""
    res = _stages(pp)[0]
    g = {s: _grads(res, f"moe.m4.{s}") for s in SCHEDULES}
    for s in ("1f1b", "interleaved"):
        np.testing.assert_allclose(res[f"moe.m4.{s}.loss"],
                                   res["moe.m4.gpipe.loss"], atol=LOSS_TOL)
        _assert_grads(g[s], g["gpipe"])
    diff = np.abs(g["1f1b"]["layers.router"] -
                  _grads(res, "moe.m4.noaux")["layers.router"]).max()
    assert diff > 1e-7


@pytest.mark.parametrize("name", list(COMPOSITIONS))
def test_composition_matches_unsharded_reference(pp, name):
    """``composition_worker.py``'s modes: the loss and every gradient
    averaged over the ranks against the unsharded single-device
    reference."""
    loss, grads = pp["model"][name]
    ranks = pp["ranks"]
    np.testing.assert_allclose(
        np.mean([float(r[f"comp.{name}.loss"]) for r in ranks]), loss,
        atol=LOSS_TOL)
    got = {k: np.mean([_grads(r, f"comp.{name}")[k] for r in ranks], axis=0)
           for k in _grads(ranks[0], f"comp.{name}")}
    _assert_grads(got, grads)


# --- in one process: pp = 1 and the errors -----------------------------------


def test_size_one_real_exchange_equals_loss_fn():
    """pp = 1 over a one-rank gloo group (the exchange is the identity):
    ``pipelined_value_and_grad`` under 1F1B equals the plain backward."""
    cfg = T.TransformerConfig(**MODEL, dtype=torch.float32)
    jcfg = JT.TransformerConfig(**MODEL, dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray,
                                JT.init_params(jax.random.PRNGKey(0), jcfg))
    p = params_from_jax(jp, cfg, device="cpu", param_dtype=torch.float32)
    b = {k: torch.from_numpy(np.array(v)).long() for k, v in
         JT.synthetic_batch(1, jcfg, batch=4).items()}
    q = {k: (v.clone().requires_grad_() if torch.is_tensor(v) else
             {n: t.clone().requires_grad_() for n, t in v.items()})
         for k, v in p.items()}
    ref = T.loss_fn(q, b, cfg)
    ref.backward()
    basics.init(device="cpu")
    try:
        with parallel.bind(parallel.make_mesh(parallel.MeshSpec(),
                                              device="cpu")):
            loss, g = T.pipelined_value_and_grad(p, b, cfg, schedule="1f1b",
                                                 n_microbatches=2)
    finally:
        basics.shutdown()
    np.testing.assert_allclose(float(loss), ref.item(), atol=LOSS_TOL)
    for name in ("embed", "ln_f", "head"):
        np.testing.assert_allclose(g[name].numpy(), q[name].grad.numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    for name, t in q["layers"].items():
        np.testing.assert_allclose(g["layers"][name].numpy(),
                                   t.grad.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def _jax_error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def _port_error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_stack_errors_match_jax():
    w = np.zeros((7, 4, 4), np.float32)
    assert _port_error(lambda: PL.stack_to_stages(torch.from_numpy(w), 4)) \
        == _jax_error(lambda: JP.stack_to_stages(jnp.asarray(w), 4))
    w6 = np.zeros((6, 4, 4), np.float32)
    assert _port_error(lambda: PL.stack_to_chunks(torch.from_numpy(w6), 4, 2,
                                                  0)) \
        == _jax_error(lambda: JP.stack_to_chunks(jnp.asarray(w6), 4, 2, 0))


def _jax_traced(fn, *args):
    """JAX's error, raised while tracing under ``shard_map`` over pp."""
    return _jax_error(lambda: jax.jit(jax.shard_map(
        fn, mesh=_pp_mesh(), in_specs=(P(),) * len(args), out_specs=P()))(
        *args))


def test_schedule_errors_match_jax():
    """An unknown schedule; the interleaved schedule's microbatches not in
    groups of P; ``n_virtual`` below 1."""
    w = np.zeros((8, 4, 4), np.float32)
    x6 = np.zeros((6, 2, 4), np.float32)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x6)

    def virtual(schedule, v=2, x=tx):
        stages = ([PL.stack_to_chunks(tw, PP, 2, s) for s in range(PP)]
                  if schedule == "interleaved"
                  else list(PL.stack_to_stages(tw, PP)))
        return lambda: PL._virtual_pipeline(
            lambda ws, h: h, stages, x, x, lambda y, t: (y - t).sum(),
            schedule=schedule, n_virtual=v)

    def jax_sched(schedule, v=2):
        def inner(w_full, xs):
            s = jax.lax.axis_index("pp")
            chunks = JP.stack_to_chunks(w_full, PP, 2, s)
            return JP.pipeline_value_and_grad(
                _stage_fn, chunks, xs, xs, lambda y, t: jnp.sum(y - t),
                axis_name="pp", schedule=schedule, n_virtual=v)[0]
        return inner

    jw, jx = jnp.asarray(w), jnp.asarray(x6)
    assert _port_error(virtual("bogus")) == _jax_traced(jax_sched("bogus"),
                                                        jw, jx)
    assert _port_error(virtual("interleaved")) == \
        _jax_traced(jax_sched("interleaved"), jw, jx)
    x8 = np.zeros((8, 2, 4), np.float32)
    assert _port_error(virtual("interleaved", 0, torch.from_numpy(x8))) == \
        _jax_traced(jax_sched("interleaved", 0), jw, jnp.asarray(x8))


@pytest.mark.parametrize("case", ["layers", "batch", "virtual"])
def test_model_errors_match_jax(case):
    """Layers that do not divide over the stages, a batch that does not
    divide into the microbatches, layers that do not divide into
    ``n_virtual`` x P chunks: JAX's texts."""
    layers = {"layers": 6, "batch": 8, "virtual": 4}[case]
    kw = {"batch": dict(n_microbatches=3),
          "virtual": dict(schedule="interleaved")}.get(case, {})
    cfg = dict(MODEL, n_layers=layers)
    jcfg = JT.TransformerConfig(**cfg, dtype=jnp.float32)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jb = JT.synthetic_batch(1, jcfg, batch=4)
    want = _jax_error(lambda: jax.jit(jax.shard_map(
        lambda pr, b: JT.pipelined_value_and_grad(pr, b, jcfg, **kw),
        mesh=_pp_mesh(), in_specs=(P(), P()), out_specs=P()))(jp, jb))
    tcfg = T.TransformerConfig(**cfg, dtype=torch.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu", param_dtype=torch.float32)
    tb = {k: torch.from_numpy(np.asarray(v)).long() for k, v in jb.items()}
    assert _port_error(lambda: T._pipelined_value_and_grad(
        tp, tb, tcfg, PL._Stages.virtual(PP), **kw)) == want


def test_unbound_pp_raises():
    cfg = T.TransformerConfig(**MODEL, dtype=torch.float32)
    p = T.init_params(cfg, device="cpu")
    tok = torch.zeros((4, 8), dtype=torch.long)
    with pytest.raises(NameError, match="unbound axis name: pp"):
        T.pipelined_value_and_grad(p, {"tokens": tok, "targets": tok}, cfg)


def test_exports_match_jax():
    import horovod_tpu.parallel as jpar

    for name in ("pipeline_apply", "pipeline_value_and_grad",
                 "stack_to_stages"):
        assert hasattr(jpar, name) and hasattr(parallel, name), name
    for name in PL.__all__:
        assert callable(getattr(JP, name)), name
