"""horovod_tpu_torch's collectives over a mesh axis or a tuple of axes
against the JAX package's in-graph forms, on the CPU.

Two jobs of gloo processes run every case once and write each rank's
results to an ``.npz``; the parent holds them, one named test a case,
against the JAX package's functions under ``shard_map`` over a mesh of
the conftest's virtual CPU devices with the same axis names and order.
Both sides take the same seeded numpy arrays, rank ``r`` (device ``r``)
slice ``r``.  The workers import only the port.

* The four-rank job (``HOROVOD_LOCAL_SIZE=2``, neither hierarchical
  flag set): Adasum over the explicit pair ``("cross", "local")`` is
  the mean over ``local``, then Adasum over ``cross``, whatever the
  flags say, as JAX's ``adasum_allreduce`` is.
* The eight-rank job on ``MeshSpec(dp=2, fsdp=2, tp=2)``: every
  collective over each single axis, ``("dp", "tp")``, ``("tp", "dp")``,
  ``("dp", "fsdp", "tp")`` and the flat ``basics.axis_name()``; Adasum,
  ``masked_average`` and the optimizers over an axis; the order-bound
  ops again on a mesh whose ranks run against its axes; then
  ``basics.init(axis_name="workers")``.  ``reinit`` at size 1 runs in
  the test's own process.

Tolerances, as ``test_torch_port_collectives.py`` states them: f32 sums
rtol 1e-6 plus 1e-6 of the largest value (summation order differs);
bf16 1e-2; Min, Max, allgather, broadcast and alltoall exact; Adasum,
masked_average and the optimizer steps 1e-5.
"""

import importlib
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
from jax.sharding import PartitionSpec as P

from horovod_tpu import basics as JB
from horovod_tpu import optim as JO
from horovod_tpu import spmd as JS
from horovod_tpu.ops import adasum as JAD
from horovod_tpu.ops import collectives as JC

# The package exports a function ``join`` that shadows the module.
JJ = importlib.import_module("horovod_tpu.join")
REPO = Path(__file__).resolve().parents[1]
N4, LOCAL = 4, 2
N8, LOCAL8 = 8, 4
MESH_AXES = ("dp", "fsdp", "tp")
AXES = {"dp": "dp", "fsdp": "fsdp", "tp": "tp", "dp_tp": ("dp", "tp"),
        "tp_dp": ("tp", "dp"), "dp_fsdp_tp": ("dp", "fsdp", "tp"),
        "flat": "hvd"}
SINGLE = [k for k, a in AXES.items() if isinstance(a, str)]
TUPLES = [k for k, a in AXES.items() if not isinstance(a, str)]
OPS = ("Sum", "Average", "Min", "Max", "Product")
# On a mesh whose ranks run against its axes (rank 7 at (0, 0, 0)): the
# order-bound ops, whose group order (ascending ranks) is then never
# JAX's.
REVERSED = {"tp": ("allgather", "broadcast", "alltoall", "alltoall.splits",
                   "reducescatter", "adasum"),
            "dp_tp": ("allgather", "broadcast", "adasum")}
ADASUM_AXES = ("dp", "fsdp", "tp", "dp_tp", "tp_dp", "flat")
# case -> (axis_name, backward_passes_per_step)
OPT_CASES = {"adasum_sgd": ("tp", 1), "adasum_adam": (("dp", "tp"), 1),
             "adasum_sgd_k2": ("dp", 2), "sparse": (("tp", "dp"), 1)}
LR = 0.05
ACTIVE = [1, 0, 1, 1, 0, 1, 1, 1]


def _inputs():
    rng = np.random.RandomState(0)
    emb = np.zeros((N8, 10, 3), np.float32)
    for r in range(N8):
        emb[r, rng.choice(10, 1 + r % 3, replace=False)] = rng.randn(
            1 + r % 3, 3)
    return {
        "x": rng.randn(N8, 6, 5).astype(np.float32),
        "x8": rng.randn(N8, 8, 5).astype(np.float32),
        "g": rng.randn(N8, 16).astype(np.float32),
        "w0": rng.randn(4, 3).astype(np.float32),
        "e0": rng.randn(10, 3).astype(np.float32),
        "gw": rng.randn(N8, 4, 3).astype(np.float32),
        "ge": emb,
    }


_PRELUDE = """
    import importlib, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from horovod_tpu_torch import basics
    join = importlib.import_module("horovod_tpu_torch.join")
    from horovod_tpu_torch.ops import adasum as AD, collectives as C

    inp, out = sys.argv[1], sys.argv[2]
    basics.init(device="cpu")
    r = basics.rank()
    d = np.load(inp)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    res = {}

    def put(key, t):
        res[key] = t.float().numpy() if torch.is_tensor(t) else np.asarray(t)

    def error(fn):
        try:
            fn()
        except (ValueError, NameError) as e:
            return f"{type(e).__name__}: {e}"
        return ""
"""

_WORKER4 = textwrap.dedent(_PRELUDE + """
    assert (basics.size(), basics.local_size(), basics.is_homogeneous()) \\
        == (4, 2, True)
    g = T(d["g"][r])
    put("pair", C.allreduce(g, C.Adasum, axis_name=("cross", "local")))
    put("pair.inplace",
        C.allreduce_(g.clone(), C.Adasum, axis_name=("cross", "local")))
    # An axis's grouped allreduce runs directly: nothing reaches the
    # eager runtime.
    from horovod_tpu_torch import eager_runtime
    rt = eager_runtime.get()
    before = rt.tensors_executed
    put("runtime.grouped", C.grouped_allreduce([g, g[:3]], C.Sum,
                                               axis_name="local")[0])
    put("runtime.tensors", rt.tensors_executed - before)
    basics.shutdown()
    np.savez(out.replace(".npz", f".{r}.npz"), **res)
""")

_WORKER8 = textwrap.dedent(_PRELUDE + """
    import json
    from horovod_tpu_torch import optim
    from horovod_tpu_torch.parallel import meshes

    cfg = json.loads(sys.argv[3])
    AXES, OPS, ADASUM, OPT = (cfg[k] for k in ("axes", "ops", "adasum",
                                               "opt"))
    x, x8, g = (T(d[k][r]) for k in ("x", "x8", "g"))
    mesh = meshes.make_mesh(meshes.MeshSpec(dp=2, fsdp=2, tp=2),
                            device="cpu")
    with meshes.bind(mesh):
        for k, a in AXES.items():
            for op in OPS:
                for dt in (torch.float32, torch.bfloat16):
                    y = C.allreduce(x.to(dt), op, axis_name=a)
                    assert y.dtype == dt
                    put(f"ar.{k}.{op}.{str(dt)[6:]}", y)
                for i, t in enumerate(C.grouped_allreduce(
                        [x, x8, g], op, axis_name=a)):
                    put(f"grouped.{k}.{op}.{i}", t)
            put(f"allgather.{k}", C.allgather(x, axis_name=a))
            put(f"allgather.uneven.{k}",
                C.allgather(x[:1 + r % 3], axis_name=a))
            put(f"broadcast.{k}", C.broadcast(x, 1, axis_name=a))
            y = x.clone()
            C.broadcast_(y, 1, axis_name=a)
            put(f"broadcast_.{k}", y)
            for i, t in enumerate(join.masked_average(
                    [x, g], cfg["active"][r], axis_name=a)):
                put(f"masked.{k}.{i}", t)
            if isinstance(a, str):
                put(f"alltoall.{k}", C.alltoall(x8, axis_name=a))
                n = (basics.size() if a == basics.axis_name()
                     else meshes.axis_size(a))
                splits = [(r + j) % 2 for j in range(n)]
                put(f"alltoall.splits.{k}",
                    C.alltoall(x8[:sum(splits)], splits, axis_name=a))
                for op in ("Sum", "Average"):
                    put(f"reducescatter.{op}.{k}",
                        C.reducescatter(x8, op, axis_name=a))
            else:
                put(f"error.alltoall.{k}",
                    error(lambda: C.alltoall(x8, axis_name=a)))
                put(f"error.reducescatter.{k}",
                    error(lambda: C.reducescatter(x8, axis_name=a)))
            if k in ADASUM:
                put(f"ar.{k}.Adasum", C.allreduce(g, C.Adasum, axis_name=a))
                put(f"adasum.{k}", AD.adasum_allreduce(g, axis_name=a))
                for i, t in enumerate(C.grouped_allreduce(
                        [x, x8, g], C.Adasum, axis_name=a)):
                    put(f"grouped.{k}.Adasum.{i}", t)
        put("error.adasum", error(lambda: AD.adasum_allreduce(
            g, axis_name=("dp", "fsdp", "tp"))))
        put("error.unbound", error(lambda: C.allreduce(x, axis_name="sp_")))

    from torch.distributed.device_mesh import DeviceMesh
    rev = DeviceMesh("cpu", torch.arange(8).flip(0).reshape(2, 2, 2),
                     mesh_dim_names=("dp", "fsdp", "tp"))
    with meshes.bind(rev):
        for k, kinds in cfg["reversed"].items():
            a = AXES[k]
            for kind in kinds:
                if kind == "allgather":
                    y = C.allgather(x[:1 + r % 3], axis_name=a)
                elif kind == "broadcast":
                    y = C.broadcast(x, 1, axis_name=a)
                elif kind == "alltoall":
                    y = C.alltoall(x8, axis_name=a)
                elif kind == "alltoall.splits":
                    splits = [(r + j) % 2 for j in range(2)]
                    y = C.alltoall(x8[:sum(splits)], splits, axis_name=a)
                elif kind == "reducescatter":
                    y = C.reducescatter(x8, C.Sum, axis_name=a)
                else:
                    y = AD.adasum_allreduce(g, axis_name=a)
                put(f"rev.{k}.{kind}", y)

    with meshes.bind(mesh):

        def step_grads(i):
            return {"w": T(d["gw"][r]) * (1.0 - 1.5 * i),
                    "embed": T(d["ge"][r]) * (1.0 + i)}

        for case, (a, k) in OPT.items():
            named = [(n, T(d[v]).clone().requires_grad_())
                     for n, v in (("w", "w0"), ("embed", "e0"))]
            ts = [t for _, t in named]
            if case.startswith("adasum"):
                inner = (torch.optim.Adam(ts, lr=cfg["lr"])
                         if "adam" in case else
                         torch.optim.SGD(ts, lr=cfg["lr"]))
                opt = optim.DistributedAdasumOptimizer(
                    inner, axis_name=a, backward_passes_per_step=k)
            else:
                opt = optim.DistributedOptimizer(
                    torch.optim.SGD(ts, lr=cfg["lr"]), named_parameters=named,
                    axis_name=a, sparse_keys=("embed",))
            for i in range(k):
                grads = step_grads(i)
                for n, t in named:
                    t.grad = grads[n]
                opt.step()
            for n, t in named:
                put(f"opt.{case}.{n}", t.detach())

    # A new flat name: the world's axis for every collective.  Rank 0
    # picks the second job's port and sends it to the others just before.
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = torch.tensor([sk.getsockname()[1] if r == 0 else 0])
    port = int(C.broadcast(port, 0)[0])
    basics.shutdown()
    basics.init(device="cpu", init_method=f"tcp://127.0.0.1:{port}",
                axis_name="workers")
    put("init.axis_name", basics.axis_name())
    put("init.mesh", list(basics.mesh().mesh_dim_names))
    put("init.workers", C.allreduce(x, C.Sum, axis_name="workers"))
    put("init.world", C.allreduce(x, C.Sum))
    put("init.error", error(lambda: C.allreduce(x, axis_name="hvd")))
    with meshes.bind(basics.mesh()):
        put("init.worker_index", basics.worker_index())
    basics.shutdown()
    np.savez(out.replace(".npz", f".{r}.npz"), **res)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(worker, n, local, tmp, inputs, *args, **env_extra):
    inp = tmp / "in.npz"
    np.savez(inp, **inputs)
    port, native_port = _free_port(), _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(r % local),
                   HOROVOD_LOCAL_SIZE=str(local),
                   HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HOROVOD_NATIVE_PORT=str(native_port),
                   PYTHONPATH=str(REPO), **env_extra)
        for k in ("HOROVOD_HIERARCHICAL_ALLREDUCE",
                  "HOROVOD_HIERARCHICAL_ALLGATHER"):
            env.pop(k, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", worker, str(inp), str(tmp / "out.npz"),
             *args], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs, tmp):
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * len(procs), \
        "\n".join(logs)
    return [dict(np.load(tmp / f"out.{r}.npz")) for r in range(len(procs))]


def _stacked(fn, mesh, spec, *arrays):
    """``fn`` per device over ``mesh`` -> a dict of arrays stacked by
    device (rank order)."""
    def inner(*blocks):
        out = fn(*[b[0] for b in blocks])
        return {k: v[None] for k, v in out.items()}

    return jax.tree_util.tree_map(np.asarray, jax.jit(JS.shard(
        inner, in_specs=(spec,) * len(arrays), out_specs=spec,
        mesh=mesh))(*arrays))


def _jax4(inputs):
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:N4]).reshape(N4 // LOCAL, LOCAL),
        ("cross", "local"))
    axes = ("cross", "local")

    def fn(g):
        return {"pair": JAD.adasum_allreduce(g, axis_name=axes)}

    return _stacked(fn, mesh, P(axes), inputs["g"][:N4])


def _raised(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return ""


def _jax_opt(case, inputs, gw, ge):
    """One step (``k`` for the accumulating case) of the JAX optimizer of
    ``case`` on this device's gradients -> its parameters."""
    a, k = OPT_CASES[case]
    params = {"w": jnp.asarray(inputs["w0"]), "embed": jnp.asarray(
        inputs["e0"])}
    if case.startswith("adasum"):
        inner = optax.adam(LR) if "adam" in case else optax.sgd(LR)
        opt = JO.DistributedAdasumOptimizer(inner, axis_name=a,
                                            backward_passes_per_step=k)
    else:
        opt = JO.DistributedOptimizer(optax.sgd(LR), axis_name=a,
                                      sparse_keys=("embed",))
    state = opt.init(params)
    for i in range(k):
        grads = {"w": gw * (1.0 - 1.5 * i), "embed": ge * (1.0 + i)}
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return params


def _jax8(inputs):
    """Every case of the eight-rank job in JAX, in-graph, and JAX's texts
    of the tuple raises (raised while tracing)."""
    devs = np.array(jax.devices()[:N8])
    errors = {}

    def cases(keys, x, x8, g, active, gw, ge):
        out = {}
        for k in keys:
            a = AXES[k]
            for op in OPS:
                for dt in (jnp.float32, jnp.bfloat16):
                    out[f"ar.{k}.{op}.{jnp.dtype(dt).name}"] = \
                        JC.allreduce(x.astype(dt), op, axis_name=a).astype(
                            jnp.float32)
                for i, t in enumerate(JC.grouped_allreduce(
                        [x, x8, g], op, axis_name=a)):
                    out[f"grouped.{k}.{op}.{i}"] = t
            out[f"allgather.{k}"] = JC.allgather(x, axis_name=a)
            out[f"broadcast.{k}"] = JC.broadcast(x, 1, axis_name=a)
            for i, t in enumerate(JJ.masked_average([x, g], active,
                                                    axis_name=a)):
                out[f"masked.{k}.{i}"] = t
            if k in SINGLE:
                out[f"alltoall.{k}"] = JC.alltoall(x8, axis_name=a)
                for op in ("Sum", "Average"):
                    out[f"reducescatter.{op}.{k}"] = JC.reducescatter(
                        x8, op, axis_name=a)
            else:
                errors[f"error.alltoall.{k}"] = _raised(
                    lambda: JC.alltoall(x8, axis_name=a))
                errors[f"error.reducescatter.{k}"] = _raised(
                    lambda: JC.reducescatter(x8, axis_name=a))
            if k in ADASUM_AXES:
                out[f"ar.{k}.Adasum"] = JC.allreduce(g, JC.Adasum,
                                                     axis_name=a)
                out[f"adasum.{k}"] = JAD.adasum_allreduce(g, axis_name=a)
                for i, t in enumerate(JC.grouped_allreduce(
                        [x, x8, g], JC.Adasum, axis_name=a)):
                    out[f"grouped.{k}.Adasum.{i}"] = t
        return out

    def mesh3_fn(*arrays):
        out = cases([k for k in AXES if k != "flat"], *arrays)
        errors["error.adasum"] = _raised(lambda: JAD.adasum_allreduce(
            arrays[2], axis_name=MESH_AXES))
        for case in OPT_CASES:
            for n, v in _jax_opt(case, inputs, *arrays[4:]).items():
                out[f"opt.{case}.{n}"] = v
        return out

    arrays = (inputs["x"], inputs["x8"], inputs["g"],
              np.asarray(ACTIVE, np.float32), inputs["gw"], inputs["ge"])
    mesh3 = jax.sharding.Mesh(devs.reshape(2, 2, 2), MESH_AXES)
    out = _stacked(mesh3_fn, mesh3, P(MESH_AXES), *arrays)
    flat = jax.sharding.Mesh(devs, (JB.axis_name(),))
    out.update(_stacked(lambda *a: cases(["flat"], *a), flat,
                        P(JB.axis_name()), *arrays))
    # The reversed mesh: device 7 at (0, 0, 0).  Blocks go by mesh place,
    # so device r's block is at place 7 - r: the inputs and the stacked
    # outputs are reversed.
    def rev_fn(x, x8, g):
        out = {}
        for k in REVERSED:
            a = AXES[k]
            out[f"rev.{k}.broadcast"] = JC.broadcast(x, 1, axis_name=a)
            out[f"rev.{k}.adasum"] = JAD.adasum_allreduce(g, axis_name=a)
            if k in SINGLE:
                out[f"rev.{k}.alltoall"] = JC.alltoall(x8, axis_name=a)
                out[f"rev.{k}.reducescatter"] = JC.reducescatter(
                    x8, JC.Sum, axis_name=a)
        return out

    rev = jax.sharding.Mesh(devs[::-1].reshape(2, 2, 2), MESH_AXES)
    out.update({k: v[::-1] for k, v in _stacked(
        rev_fn, rev, P(MESH_AXES),
        *(inputs[n][::-1] for n in ("x", "x8", "g"))).items()})
    workers = jax.sharding.Mesh(devs, ("workers",))
    out.update(_stacked(lambda x: {"init.workers": JC.allreduce(
        x, JC.Sum, axis_name="workers")}, workers, P("workers"),
        inputs["x"]))
    return out, errors


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both jobs run while the JAX side computes."""
    import json

    inputs = _inputs()
    t4, t8 = (tmp_path_factory.mktemp(n) for n in ("axes4", "axes8"))
    cfg = json.dumps({"axes": AXES, "ops": OPS, "adasum": ADASUM_AXES,
                      "opt": OPT_CASES, "active": ACTIVE, "lr": LR,
                      "reversed": REVERSED})
    p4 = _start(_WORKER4, N4, LOCAL, t4, inputs)
    p8 = _start(_WORKER8, N8, LOCAL8, t8, inputs, cfg, HOROVOD_NATIVE="0")
    jx4 = _jax4(inputs)
    jx8, errors = _jax8(inputs)
    port = {"4": _finish(p4, t4), "8": _finish(p8, t8)}
    return inputs, port, {**jx4, **jx8}, errors


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    atol = tol * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _group(k, r, reversed_mesh=False):
    """Rank ``r``'s ranks along ``AXES[k]``, in JAX's order (the first
    axis outermost), on the mesh of ranks in order or reversed."""
    a = AXES[k]
    if k == "flat":
        return list(range(N8))
    names = (a,) if isinstance(a, str) else a
    dims = [MESH_AXES.index(n) for n in names]
    rest = [d for d in range(3) if d not in dims]
    grid = np.arange(N8)[::-1] if reversed_mesh else np.arange(N8)
    grid = grid.reshape(2, 2, 2).transpose(*rest, *dims)
    rows = grid.reshape(-1, 2 ** len(dims)).tolist()
    return next(row for row in rows if r in row)


# --- the four-rank job -----------------------------------------------------


@pytest.mark.parametrize("key", ["pair", "pair.inplace"])
def test_explicit_pair_adasum_ignores_the_flags(results, key):
    """Four ranks, two a host, neither hierarchical flag set: Adasum over
    ``("cross", "local")`` is the mean over ``local``, then Adasum over
    ``cross`` (JAX's ``adasum_allreduce``), not a flat Adasum over the
    four ranks."""
    _, port, jx, _ = results
    for r in range(N4):
        _close(port["4"][r][key], jx["pair"][r], 1e-5)


def test_axis_grouped_allreduce_is_direct(results):
    """``grouped_allreduce`` over an axis sums that axis's ranks and
    sends nothing through the eager runtime (it negotiates over the
    world)."""
    inputs, port, _, _ = results
    for r in range(N4):
        host = [c for c in range(N4) if c // LOCAL == r // LOCAL]
        _close(port["4"][r]["runtime.grouped"],
               inputs["g"][host].sum(0), 1e-6)
        assert int(port["4"][r]["runtime.tensors"]) == 0


# --- the eight-rank job ----------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("k", list(AXES))
def test_allreduce_over_axes(results, k, op, dt):
    _, port, jx, _ = results
    key = f"ar.{k}.{op}.{dt}"
    for r in range(N8):
        got, want = port["8"][r][key], jx[key][r]
        if op in ("Min", "Max") and dt == "float32":
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want, 1e-6 if dt == "float32" else 1e-2)


@pytest.mark.parametrize("k,op", [(k, op) for k in AXES for op in OPS]
                         + [(k, "Adasum") for k in ADASUM_AXES])
def test_grouped_allreduce_over_axes(results, k, op):
    """Per tensor, as JAX's in-graph ``grouped_allreduce``: the fusion
    buckets, or Adasum with one coefficient pair a tensor."""
    _, port, jx, _ = results
    for r in range(N8):
        for i in range(3):
            key = f"grouped.{k}.{op}.{i}"
            if op in ("Min", "Max"):
                np.testing.assert_array_equal(port["8"][r][key], jx[key][r])
            else:
                _close(port["8"][r][key], jx[key][r],
                       1e-5 if op == "Adasum" else 1e-6)


@pytest.mark.parametrize("kind", ["allgather", "broadcast", "broadcast_"])
@pytest.mark.parametrize("k", list(AXES))
def test_gather_and_broadcast_over_axes(results, k, kind):
    """Exact: allgather's blocks in JAX's order for the tuple, and the
    broadcast from index 1 along it (JAX's masked psum)."""
    _, port, jx, _ = results
    for r in range(N8):
        np.testing.assert_array_equal(port["8"][r][f"{kind}.{k}"],
                                      jx[f"{kind.rstrip('_')}.{k}"][r])


@pytest.mark.parametrize("k", list(AXES))
def test_uneven_rows_over_axes(results, k):
    """allgather of ``1 + r % 3`` rows and, on one axis, alltoall with
    splits, against numpy over the axis's ranks in JAX's order."""
    inputs, port, _, _ = results
    x, x8 = inputs["x"], inputs["x8"]
    for r in range(N8):
        ranks = _group(k, r)
        np.testing.assert_array_equal(
            port["8"][r][f"allgather.uneven.{k}"],
            np.concatenate([x[s][:1 + s % 3] for s in ranks]))
        if k not in SINGLE:
            continue
        i, n = ranks.index(r), len(ranks)
        want = []
        for s in ranks:
            splits = [(s + j) % 2 for j in range(n)]
            want.append(x8[s][sum(splits[:i]):sum(splits[:i + 1])])
        np.testing.assert_array_equal(port["8"][r][f"alltoall.splits.{k}"],
                                      np.concatenate(want))


@pytest.mark.parametrize("kind", ["alltoall", "reducescatter.Sum",
                                  "reducescatter.Average"])
@pytest.mark.parametrize("k", SINGLE)
def test_alltoall_and_reducescatter_on_one_axis(results, k, kind):
    """alltoall exact; reducescatter's sums in another order (Average
    divides by the axis's size)."""
    _, port, jx, _ = results
    for r in range(N8):
        got, want = port["8"][r][f"{kind}.{k}"], jx[f"{kind}.{k}"][r]
        if kind == "alltoall":
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want, 1e-6)


@pytest.mark.parametrize("kind", ["alltoall", "reducescatter"])
@pytest.mark.parametrize("k", TUPLES)
def test_tuple_of_axes_raises_jax_text(results, k, kind):
    _, port, _, errors = results
    want = errors[f"error.{kind}.{k}"]
    assert want == f"ValueError: {kind} supports a single mesh axis"
    for r in range(N8):
        assert str(port["8"][r][f"error.{kind}.{k}"]) == want


@pytest.mark.parametrize("k", ADASUM_AXES)
def test_adasum_over_axes(results, k):
    """``adasum_allreduce`` and ``allreduce(op=Adasum)`` over one axis
    (the exchange in the axis's order) and over a pair in both orders
    (the mean over the second axis, Adasum over the first)."""
    _, port, jx, _ = results
    for r in range(N8):
        _close(port["8"][r][f"adasum.{k}"], jx[f"adasum.{k}"][r], 1e-5)
        _close(port["8"][r][f"ar.{k}.Adasum"], jx[f"ar.{k}.Adasum"][r],
               1e-5)


def test_adasum_over_three_axes_and_unbound_axis_raise(results):
    _, port, _, errors = results
    assert errors["error.adasum"] == \
        "ValueError: adasum_allreduce takes one axis or (cross, local)"
    for r in range(N8):
        assert str(port["8"][r]["error.adasum"]) == errors["error.adasum"]
        assert str(port["8"][r]["error.unbound"]).startswith(
            "NameError: Found an unbound axis name: sp_")


@pytest.mark.parametrize("k", list(AXES))
def test_masked_average_over_axes(results, k):
    _, port, jx, _ = results
    for r in range(N8):
        for i in range(2):
            _close(port["8"][r][f"masked.{k}.{i}"], jx[f"masked.{k}.{i}"][r],
                   1e-5)


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_step_over_axes(results, case):
    """``DistributedAdasumOptimizer`` (SGD; Adam over a pair; SGD at
    ``backward_passes_per_step=2``) and ``DistributedOptimizer`` with
    ``sparse_keys`` over a tuple (its embedding reduces densely over the
    axes, as JAX's traced leaf does) against the JAX optimizers."""
    _, port, jx, _ = results
    for r in range(N8):
        for n in ("w", "embed"):
            key = f"opt.{case}.{n}"
            _close(port["8"][r][key], jx[key][r], 1e-5)


def test_init_axis_name(results):
    """After ``init(axis_name="workers")`` the flat mesh takes the name,
    an allreduce over it is the world's (JAX's psum over ``workers``),
    the old name is unbound and ``worker_index`` reads the new axis."""
    _, port, jx, _ = results
    for r in range(N8):
        res = port["8"][r]
        assert str(res["init.axis_name"]) == "workers"
        assert list(res["init.mesh"]) == ["workers"]
        _close(res["init.workers"], jx["init.workers"][r], 1e-6)
        np.testing.assert_array_equal(res["init.workers"], res["init.world"])
        assert str(res["init.error"]).startswith(
            "NameError: Found an unbound axis name: hvd")
        assert int(res["init.worker_index"]) == r


def test_reinit_keeps_the_axis_name(monkeypatch):
    """At size 1 in this process: ``reinit`` keeps the flat axis's name
    unless given another, and the collectives follow it."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import collectives as C

    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_NUM_PROC",
              "HOROVOD_LOCAL_RANK", "HOROVOD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_NATIVE", "0")
    x = torch.arange(6.0)
    basics.init(device="cpu", axis_name="workers")
    try:
        basics.reinit()
        assert basics.axis_name() == "workers"
        assert basics.mesh().mesh_dim_names == ("workers",)
        assert torch.equal(C.allreduce(x, C.Sum, axis_name="workers"), x)
        basics.reinit(axis_name="hvd")
        assert basics.axis_name() == "hvd"
        with pytest.raises(NameError, match="unbound axis name: workers"):
            C.allreduce(x, axis_name="workers")
    finally:
        basics.shutdown()


@pytest.mark.parametrize("k,kind", [(k, kind) for k, kinds in
                                    REVERSED.items() for kind in kinds])
def test_order_bound_ops_on_a_reversed_mesh(results, k, kind):
    """On a mesh whose ranks run against its axes, the group's order
    (ascending ranks) is never JAX's: allgather's blocks (numpy, uneven
    rows), broadcast's root, alltoall's slices (with splits: numpy),
    reducescatter's and Adasum's pairing equal JAX's over the reversed
    device mesh."""
    inputs, port, jx, _ = results
    x, x8 = inputs["x"], inputs["x8"]
    for r in range(N8):
        got = port["8"][r][f"rev.{k}.{kind}"]
        ranks = _group(k, r, reversed_mesh=True)
        if kind == "allgather":
            want = np.concatenate([x[s][:1 + s % 3] for s in ranks])
        elif kind == "alltoall.splits":
            i = ranks.index(r)
            want = []
            for s in ranks:
                splits = [(s + j) % 2 for j in range(len(ranks))]
                want.append(x8[s][sum(splits[:i]):sum(splits[:i + 1])])
            want = np.concatenate(want)
        else:
            want = jx[f"rev.{k}.{kind}"][r]
        if kind in ("reducescatter", "adasum"):
            _close(got, want, 1e-6 if kind == "reducescatter" else 1e-5)
        else:
            np.testing.assert_array_equal(got, want)
