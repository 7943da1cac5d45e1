"""horovod_tpu_torch's collectives, Adasum, sparse reduction, state
broadcast and join against the JAX package, on the CPU.

One job of four gloo processes (``HOROVOD_LOCAL_SIZE=2``: two hosts of
two ranks, so the hierarchical ops run at 2 x 2) runs every case once
and writes each rank's results to an ``.npz``; the parent holds them,
one named test a case, against the JAX package's in-graph ops over a
sub-mesh of the conftest's virtual CPU devices: ``("w",)`` of 4 for the
flat ops, ``("cross", "local")`` of 2 x 2 for the hierarchical ones.
Both sides take the same seeded numpy arrays, rank ``r`` (device ``r``)
slice ``r``.  The workers import only the port.

Tolerances: f32 sums and products rtol 1e-6 (plus 1e-6 of the largest
value: summation order differs, also between a fused bucket and one
tensor); bf16 1e-2 (XLA keeps the scaled bf16 values in f32 where the
port rounds them); f32 Min and Max, allgather, broadcast and alltoall
exact; Adasum, sparse and masked_average 1e-5 (f32 dot products and
sums in another order).
"""

import dataclasses
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
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu import basics as JB
from horovod_tpu import spmd as JS
from horovod_tpu.ops import adasum as JAD
from horovod_tpu.ops import collectives as JC
from horovod_tpu.ops.compression import Compression as JComp
from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import adasum as AD
from horovod_tpu_torch.ops import collectives as C

# The package exports a function ``join`` that shadows the module.
JJ = importlib.import_module("horovod_tpu.join")
REPO = Path(__file__).resolve().parents[1]
N, LOCAL = 4, 2
OPS = ("Sum", "Average", "Min", "Max", "Product")
SCALES = {"plain": (1.0, 1.0), "scaled": (0.5, 3.0)}
ACTIVE = {"some": [1, 0, 1, 1], "none": [0, 0, 0, 0]}


def _inputs():
    rng = np.random.RandomState(0)
    splits = np.array([[1, 0, 2, 3], [2, 2, 1, 1], [0, 3, 3, 0],
                       [1, 1, 1, 3]], np.int64)  # [rank, destination]
    sparse = np.zeros((N, 10, 3), np.float32)
    for r, rows in enumerate([[1, 4], [4, 7, 9], [], [0, 1]]):
        sparse[r, rows] = rng.randn(len(rows), 3)
    return {
        "x": rng.randn(N, 6, 5).astype(np.float32),
        "x8": rng.randn(N, 8, 5).astype(np.float32),
        "odd": rng.randn(N, 29).astype(np.float32),
        "g": rng.randn(N, 16).astype(np.float32),
        "splits": splits,
        "tall": rng.randn(N, 6, 2).astype(np.float32),
        "sparse": sparse,
    }


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from horovod_tpu_torch import basics, join, state
    from horovod_tpu_torch.ops import adasum as AD, collectives as C
    from horovod_tpu_torch.ops import sparse as SP
    from horovod_tpu_torch.ops.compression import Compression

    inp, out = sys.argv[1], sys.argv[2]
    basics.init(device="cpu")
    r, n = basics.rank(), basics.size()
    assert (n, basics.local_size(), basics.cross_size(),
            basics.cross_rank(), basics.is_homogeneous()) == (
                4, 2, 2, r // 2, True)
    d = np.load(inp)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    x, x8, odd, g = (T(d[k][r]) for k in ("x", "x8", "odd", "g"))
    res = {}

    def put(key, t):
        res[key] = t.float().numpy() if torch.is_tensor(t) else np.asarray(t)

    def error(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return ""

    for op in ("Sum", "Average", "Min", "Max", "Product"):
        for scale, (pre, post) in (("plain", (1.0, 1.0)),
                                   ("scaled", (0.5, 3.0))):
            for dt in (torch.float32, torch.bfloat16):
                y = C.allreduce(x.to(dt), op, prescale_factor=pre,
                                postscale_factor=post)
                assert y.dtype == dt
                put(f"ar.{op}.{scale}.{str(dt)[6:]}", y)
    y = C.allreduce(x, C.Sum, compression=Compression.bf16)
    assert y.dtype == torch.float32
    put("ar.compression", y)
    put("process_sum", C.process_sum(x))
    put("allgather", C.allgather(x))
    put("allgather.uneven", C.allgather(T(d["tall"][r][:r + 1])))
    put("broadcast", C.broadcast(x, 2))
    put("alltoall", C.alltoall(x8))
    put("alltoall.splits", C.alltoall(x8[:6], d["splits"][r].tolist()))
    for op in ("Sum", "Average"):
        put(f"reducescatter.{op}", C.reducescatter(x8, op))
    with C._hierarchical(True):
        for op in ("Sum", "Average"):
            put(f"hier.allreduce.{op}", C.allreduce(odd, op))
        put("hier.allgather", C.allgather(x))
        put("hier.adasum", C.allreduce(g, C.Adasum))
    group = [x, x8, odd]
    for op in ("Average", "Adasum"):
        for i, t in enumerate(C.grouped_allreduce(group, op)):
            put(f"grouped.{op}.{i}", t)
    put("grouped.sum_scaled.0", C.grouped_allreduce(
        group, C.Sum, prescale_factor=0.5, postscale_factor=3.0)[0])

    # async: each op's handle, polled and synchronized once.
    handles = {
        "allreduce": C.allreduce_async(x, C.Average, prescale_factor=0.5,
                                       postscale_factor=3.0),
        "allreduce_bf16": C.allreduce_async(
            x, C.Sum, compression=Compression.bf16),
        "allgather": C.allgather_async(x),
        "broadcast": C.broadcast_async(x, 2),
        "reducescatter": C.reducescatter_async(x8, C.Sum),
        "alltoall": C.alltoall_async(x8),
        "alltoall_splits": C.alltoall_async(x8[:6],
                                            d["splits"][r].tolist()),
    }
    for k, h in handles.items():
        C.poll(h)
        put(f"async.{k}", C.synchronize(h))
        assert C.poll(h)
        put(f"async.{k}.reused", error(lambda: C.synchronize(h)) != "")

    put("adasum", C.allreduce(g, C.Adasum))
    put("adasum.stack", AD.adasum_reduce_stack(C.allgather(g[None])))
    put("adasum.zero", C.allreduce(torch.zeros(8), C.Adasum))
    put("adasum.zero_rank", C.allreduce(g if r != 1 else torch.zeros(16),
                                        C.Adasum))
    for s in (1e-3, 1.0, 1e3):
        put(f"adasum.scale.{s}", C.allreduce(T(d["g"][0]) * s, C.Adasum))

    sp = T(d["sparse"][r])
    for op in ("Sum", "Average"):
        got, stats = SP.sparse_allreduce(sp, op, return_stats=True)
        put(f"sparse.{op}", got)
        put(f"sparse.{op}.dense", C.allreduce(sp, op))
        put(f"sparse.{op}.rows", stats["rows"])
    put("broadcast_object", state.broadcast_object({"r": r, "s": "x" * r},
                                                   root_rank=1)["r"])
    put("allgather_object", [o[0] for o in state.allgather_object(
        (r, "y" * r))])
    put("join", join.join())
    for name, flags in (("some", [1, 0, 1, 1]), ("none", [0, 0, 0, 0])):
        a, b = join.masked_average([x, g], flags[r])
        put(f"masked.{name}.0", a)
        put(f"masked.{name}.1", b)
    put("error.reducescatter", error(lambda: C.reducescatter(x, C.Sum)))
    put("error.alltoall", error(lambda: C.alltoall(x8[:6])))
    C.barrier()
    basics.shutdown()
    np.savez(out.replace(".npz", f".{r}.npz"), **res)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp, inputs):
    inp = tmp / "in.npz"
    np.savez(inp, **inputs)
    port = _free_port()
    procs = []
    for r in range(N):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(r % LOCAL),
                   HOROVOD_LOCAL_SIZE=str(LOCAL),
                   HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   # grouped_allreduce's three tensors in three buckets
                   HOROVOD_FUSION_THRESHOLD="256",
                   PYTHONPATH=str(REPO))
        for k in ("HOROVOD_HIERARCHICAL_ALLREDUCE",
                  "HOROVOD_HIERARCHICAL_ALLGATHER"):
            env.pop(k, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(inp), str(tmp / "out.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * N, "\n".join(logs)
    return [dict(np.load(tmp / f"out.{r}.npz")) for r in range(N)]


def _stacked(fn, mesh, spec, *arrays):
    """``fn`` per device over ``mesh`` -> a dict of arrays stacked by
    device (rank order)."""
    def inner(*blocks):
        out = fn(*[b[0] for b in blocks])
        return {k: v[None] for k, v in out.items()}

    return jax.tree_util.tree_map(np.asarray, jax.jit(JS.shard(
        inner, in_specs=(spec,) * len(arrays), out_specs=spec,
        mesh=mesh))(*arrays))


def _jax_flat(inputs):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:N]), ("w",))
    w = "w"

    def fn(x, x8, odd, g, active_some, active_none):
        out = {}
        for op in OPS:
            for scale, (pre, post) in SCALES.items():
                for dt in (jnp.float32, jnp.bfloat16):
                    out[f"ar.{op}.{scale}.{jnp.dtype(dt).name}"] = \
                        JC.allreduce(x.astype(dt), op, axis_name=w,
                                     prescale_factor=pre,
                                     postscale_factor=post).astype(
                                         jnp.float32)
        out["ar.compression"] = JC.allreduce(
            x, JC.Sum, axis_name=w, compression=JComp.bf16)
        out["allgather"] = JC.allgather(x, axis_name=w)
        out["broadcast"] = JC.broadcast(x, 2, axis_name=w)
        out["alltoall"] = JC.alltoall(x8, axis_name=w)
        for op in ("Sum", "Average"):
            out[f"reducescatter.{op}"] = JC.reducescatter(x8, op,
                                                          axis_name=w)
            out[f"flat.allreduce.{op}"] = JC.allreduce(odd, op, axis_name=w)
        for i, t in enumerate((x, x8, odd)):
            out[f"each.Average.{i}"] = JC.allreduce(t, JC.Average,
                                                    axis_name=w)
            out[f"each.Adasum.{i}"] = JC.allreduce(t, JC.Adasum, axis_name=w)
        out["adasum"] = JAD.adasum_allreduce(g, axis_name=w)
        out["adasum.zero_rank"] = JAD.adasum_allreduce(
            jnp.where(JB.worker_index(w) == 1, 0.0, 1.0) * g, axis_name=w)
        out["masked.some.0"], out["masked.some.1"] = JJ.masked_average(
            [x, g], active_some, axis_name=w)
        out["masked.none.0"], out["masked.none.1"] = JJ.masked_average(
            [x, g], active_none, axis_name=w)
        return out

    a = {k: np.asarray(v, np.float32) for k, v in ACTIVE.items()}
    return _stacked(fn, mesh, P(w), inputs["x"], inputs["x8"],
                    inputs["odd"], inputs["g"], a["some"], a["none"])


def _jax_hier(inputs, monkeypatch):
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "1")
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLGATHER", "1")
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:N]).reshape(N // LOCAL, LOCAL),
        ("cross", "local"))
    axes = ("cross", "local")

    def fn(x, odd, g):
        out = {f"hier.allreduce.{op}": JC.allreduce(odd, op, axis_name=axes)
               for op in ("Sum", "Average")}
        out["hier.allgather"] = JC.allgather(x, axis_name=axes)
        out["hier.adasum"] = JAD.adasum_allreduce(g, axis_name=axes)
        return out

    return _stacked(fn, mesh, P(axes), inputs["x"], inputs["odd"],
                    inputs["g"])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    inputs = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        jflat = _jax_flat(inputs)
        jhier = _jax_hier(inputs, mp)
    port = _run_workers(tmp_path_factory.mktemp("collectives"), inputs)
    return inputs, port, {**jflat, **jhier}


def _close(got, want, tol, rel_max=True):
    want = np.asarray(want, np.float32)
    atol = tol * max(float(np.abs(want).max()), 1.0) if rel_max else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("op", OPS)
def test_allreduce_matches_jax(results, op, scale, dt):
    _, port, jx = results
    key = f"ar.{op}.{scale}.{dt}"
    for r in range(N):
        got, want = port[r][key], jx[key][r]
        if op in ("Min", "Max") and dt == "float32":
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want, 1e-6 if dt == "float32" else 1e-2)


def test_allreduce_compression_and_process_sum(results):
    _, port, jx = results
    for r in range(N):
        _close(port[r]["ar.compression"], jx["ar.compression"][r], 1e-2)
        np.testing.assert_array_equal(port[r]["process_sum"],
                                      port[r]["ar.Sum.plain.float32"])


@pytest.mark.parametrize("key", ["allgather", "broadcast", "alltoall",
                                 "reducescatter.Sum",
                                 "reducescatter.Average"])
def test_data_movement(results, key):
    """Exact, but for reducescatter's sums (their order differs)."""
    _, port, jx = results
    for r in range(N):
        if key.startswith("reducescatter"):
            _close(port[r][key], jx[key][r], 1e-6)
        else:
            np.testing.assert_array_equal(port[r][key], jx[key][r])


def test_allgather_uneven_rows(results):
    inputs, port, _ = results
    want = np.concatenate([inputs["tall"][r][:r + 1] for r in range(N)])
    for r in range(N):
        np.testing.assert_array_equal(port[r]["allgather.uneven"], want)


def test_alltoall_uneven_splits_against_numpy(results):
    inputs, port, _ = results
    sp, x8 = inputs["splits"], inputs["x8"]
    for r in range(N):
        want = [x8[s][:6][sp[s][:r].sum():sp[s][:r + 1].sum()]
                for s in range(N)]
        np.testing.assert_array_equal(port[r]["alltoall.splits"],
                                      np.concatenate(want))


@pytest.mark.parametrize("key", ["hier.allreduce.Sum",
                                 "hier.allreduce.Average", "hier.allgather"])
def test_hierarchical_matches_jax_and_flat(results, key):
    """2 x 2: the two-level ops against JAX's (``_hier_psum`` with the
    padding of a 29-element tensor, staged allgather) and the flat
    ones."""
    _, port, jx = results
    flat = {"hier.allreduce.Sum": "flat.allreduce.Sum",
            "hier.allreduce.Average": "flat.allreduce.Average",
            "hier.allgather": "allgather"}[key]
    for r in range(N):
        _close(port[r][key], jx[key][r], 1e-6)
        _close(port[r][key], jx[flat][r], 1e-6)


@pytest.mark.parametrize("op", ["Average", "Adasum"])
def test_grouped_allreduce_equals_per_tensor(results, op):
    """Average through the fusion buckets, Adasum with one coefficient
    pair a tensor: each equals the per-tensor allreduce (JAX, in-graph)."""
    _, port, jx = results
    for r in range(N):
        for i in range(3):
            _close(port[r][f"grouped.{op}.{i}"], jx[f"each.{op}.{i}"][r],
                   1e-6 if op == "Average" else 1e-5)
        _close(port[r]["grouped.sum_scaled.0"],
               port[r]["ar.Sum.scaled.float32"], 1e-6)


@pytest.mark.parametrize("op,sync", [
    ("allreduce", "ar.Average.scaled.float32"),
    ("allreduce_bf16", "ar.compression"), ("allgather", "allgather"),
    ("broadcast", "broadcast"), ("reducescatter", "reducescatter.Sum"),
    ("alltoall", "alltoall"), ("alltoall_splits", "alltoall.splits")])
def test_async_equals_sync_and_handles_are_single_use(results, op, sync):
    _, port, _ = results
    for r in range(N):
        np.testing.assert_array_equal(port[r][f"async.{op}"], port[r][sync])
        assert port[r][f"async.{op}.reused"]


@pytest.mark.parametrize("key", ["adasum", "adasum.zero_rank",
                                 "hier.adasum"])
def test_adasum_matches_jax(results, key):
    _, port, jx = results
    for r in range(N):
        _close(port[r][key], jx[key][r], 1e-5)
        np.testing.assert_array_equal(port[r][key], port[0][key])


def test_adasum_against_the_stack_oracle_and_invariants(results):
    inputs, port, _ = results
    want = np.asarray(JAD.adasum_reduce_stack(inputs["g"]))
    got_stack = np.asarray(AD.adasum_reduce_stack(torch.from_numpy(
        inputs["g"])))
    _close(got_stack, want, 1e-5)
    g0 = inputs["g"][0]
    for r in range(N):
        _close(port[r]["adasum"], want, 1e-5)
        _close(port[r]["adasum.stack"], want, 1e-5)
        np.testing.assert_array_equal(port[r]["adasum.zero"], np.zeros(8))
        for s in (1e-3, 1.0, 1e3):  # Adasum of {g, g, g, g} is g
            np.testing.assert_allclose(port[r][f"adasum.scale.{s}"], g0 * s,
                                       rtol=1e-5, atol=1e-6 * s)


def test_adasum_errors_and_size_one(monkeypatch):
    """A size that is not a power of two raises JAX's error before any
    exchange; at size 1 Adasum is the identity."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:3]), ("w",))
    with pytest.raises(ValueError) as je:
        jax.jit(JS.shard(lambda t: JAD.adasum_allreduce(t, axis_name="w"),
                         in_specs=P("w"), out_specs=P("w"), mesh=mesh))(
            np.ones((3, 2), np.float32))
    basics.init(device="cpu")
    try:
        x = torch.randn(5)
        assert torch.equal(AD.adasum_allreduce(x), x)
        ctx = basics._ctx()
        monkeypatch.setattr(basics, "_ctx",
                            lambda: dataclasses.replace(ctx, size=3))
        with pytest.raises(ValueError) as e:
            C.allreduce(x, C.Adasum)
        assert str(e.value) == str(je.value)
    finally:
        monkeypatch.undo()
        basics.shutdown()


@pytest.mark.parametrize("op", ["Sum", "Average"])
def test_sparse_allreduce_equals_dense_and_numpy(results, op):
    """Rank 2 touches no row; 6 distinct rows in all (row 1 and 4
    twice)."""
    inputs, port, _ = results
    want = inputs["sparse"].sum(0) / (N if op == "Average" else 1)
    for r in range(N):
        _close(port[r][f"sparse.{op}"], want, 1e-5)
        _close(port[r][f"sparse.{op}"], port[r][f"sparse.{op}.dense"], 1e-5)
    assert [int(port[r]["sparse.Sum.rows"]) for r in range(N)] == \
        [2, 3, 0, 2]


def test_broadcast_and_allgather_object(results):
    _, port, _ = results
    for r in range(N):
        assert int(port[r]["broadcast_object"]) == 1
        assert port[r]["allgather_object"].tolist() == [0, 1, 2, 3]


def test_join_returns_the_same_rank_everywhere(results):
    _, port, _ = results
    assert [int(port[r]["join"]) for r in range(N)] == [N - 1] * N


@pytest.mark.parametrize("flags", list(ACTIVE))
def test_masked_average_matches_jax(results, flags):
    _, port, jx = results
    for r in range(N):
        for i in range(2):
            key = f"masked.{flags}.{i}"
            assert np.isfinite(port[r][key]).all()
            _close(port[r][key], jx[key][r], 1e-6)
    if flags == "none":
        assert not np.abs(port[0]["masked.none.0"]).any()


def test_errors_match_jax(results, monkeypatch):
    """The messages of a bad op, reducescatter's dim-0 divisibility (dim
    0 of 6 at 4 ranks) and alltoall's, as the JAX package words them."""
    _, port, _ = results
    monkeypatch.setattr(JB, "is_initialized", lambda: True)
    monkeypatch.setattr(JB, "cross_size", lambda: N)
    with pytest.raises(ValueError) as je:
        JC._validate_reducescatter(np.zeros((6, 5)), JC.Sum)
    assert str(port[0]["error.reducescatter"]) == str(je.value)
    assert str(port[0]["error.alltoall"]) == \
        "alltoall without splits requires dim0 % size == 0"
    with pytest.raises(ValueError) as e:
        C.allreduce(torch.ones(2), "Median")
    with pytest.raises(ValueError) as je:
        JC.allreduce(np.ones(2), "Median")
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="Sum/Average"):
        C.reducescatter(torch.ones(2), C.Max)
