"""horovod_tpu_torch's worker mesh and GSPMD training against the JAX
package, on the CPU: ``hvd.mesh`` and its names, ``PartitionSpec``
shardings over DTensor, ``spmd.shard`` / ``run``, ``make_gspmd_train_step``
over dp, fsdp, tp and sp, the ``DataLoader``'s pod mode and pod
checkpoints.

One job of four gloo ranks, started by the port's own launcher
(``runner.launch.launch_job``, hosts ``localhost-a:2`` and
``localhost-b:2``, as ``tests/test_gspmd_multiprocess.py`` starts JAX's),
runs ``tests/torch_port_gspmd_worker.py`` over every multi-rank case; a
one-process job then runs the size-1 cases and restores the four ranks'
checkpoint.  The parent computes the JAX side while the ranks run: JAX's
``make_gspmd_train_step`` over ``make_mesh(spec, jax.devices()[:4])`` on
the conftest's virtual CPU devices, with the same seeded weights and
batches (f32, ``tests/test_models.py``'s small configs), and holds each
case, one named test each, against it.

Tolerances: the GSPMD step against JAX's, the loss at rtol
:data:`LOSS_RTOL` and every parameter at :data:`PARAM_RTOL` /
:data:`PARAM_ATOL` (JAX's own, ``tests/test_models.py:416-422``, are
1e-4 and 5e-3 / 1e-4); the size-1 step against ``make_train_step`` and a
resumed run in the same layout bit for bit.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from horovod_tpu import spmd as JS
from horovod_tpu.data import DataLoader as JDataLoader
from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import meshes as JM
from horovod_tpu_torch.runner import launch
from horovod_tpu_torch.runner.hosts import HostSpec

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_port_gspmd_worker.py"
N = 4
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=16)
CONFIGS = {"A": SMALL, "C": dict(SMALL, n_experts=2)}
SEEDS = {"A": 1, "C": 0}  # jax.random.PRNGKey, as tests/test_models.py
LR = {"sgd": 1e-1, "adam": 1e-2, "adamw": 1e-2}
# case: (config, mesh axes, optimizer, global batch, steps)
CASES = {"a": ("A", {"dp": 2, "tp": 2}, "sgd", 4, 2),
         "b": ("A", {"fsdp": 2, "tp": 2}, "adam", 8, 2),
         "c": ("C", {"sp": 2, "tp": 2}, "sgd", 4, 1)}
# (mesh, spec) pairs whose placement each rank reports for an (8, 4)
# array; lists are tuples of axes.
PLACEMENTS = [("flat", ["hvd"]), ("flat", [None, "hvd"]),
              ("hier", [["cross", "local"]]), ("hier", ["local", "cross"]),
              ("hier", [None, "cross"]), ("dp_fsdp", [["dp", "fsdp"]]),
              ("dp_fsdp", ["fsdp", "dp"])]
LOADER_MESHES = {"dp_tp": {"dp": 2, "tp": 2}, "dp_fsdp": {"dp": 2, "fsdp": 2}}
LOADER_ROWS, LOADER_BATCH = 32, 8


def _flat(tree, prefix):
    return {prefix + jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_params(name):
    cfg = JT.TransformerConfig(**CONFIGS[name], dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.PRNGKey(SEEDS[name]), cfg))


def _inputs():
    rng = np.random.RandomState(0)
    arrays = {}
    for case, (name, _, _, B, steps) in CASES.items():
        for i in range(steps):
            tok = rng.randint(0, SMALL["vocab_size"],
                              (B, SMALL["max_seq"])).astype(np.int32)
            arrays[f"{case}.tokens.{i}"] = tok
            arrays[f"{case}.targets.{i}"] = np.roll(tok, -1, axis=1)
    tok = rng.randint(0, SMALL["vocab_size"],
                      (LOADER_ROWS, SMALL["max_seq"])).astype(np.int32)
    arrays["loader.tokens"] = tok
    arrays["loader.targets"] = np.roll(tok, -1, axis=1)
    return arrays


def _batches(arrays, case):
    return [{k: arrays[f"{case}.{k}.{i}"] for k in ("tokens", "targets")}
            for i in range(CASES[case][4])]


def _env(tmp):
    return {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": str(REPO),
            "HOROVOD_NATIVE": "0"}


def _start_pod(tmp, result):
    """The four-rank job, in a thread (``launch_job`` blocks); each rank
    under ``timeout`` so that a hang ends the job."""
    def run():
        result["rc"] = launch.launch_job(
            ["timeout", "-k", "10", "300", sys.executable, str(WORKER),
             "pod", str(tmp / "in.npz"), str(tmp)],
            [HostSpec("localhost-a", 2), HostSpec("localhost-b", 2)],
            env=_env(tmp), output_filename=str(tmp / "pod_logs"))

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread


def _logs(d):
    return "".join(p.read_text() for p in sorted(Path(d).rglob("*"))
                   if p.is_file())[-6000:]


# --- the JAX side ------------------------------------------------------------


def _jax_case(case, jparams, arrays):
    """JAX's GSPMD step over ``case``'s mesh on four virtual devices: the
    losses and the parameters after the last step."""
    name, axes, kind, _, _ = CASES[case]
    cfg = JT.TransformerConfig(**CONFIGS[name], dtype=jnp.float32)
    opt = {"sgd": optax.sgd, "adam": optax.adam}[kind](LR[kind])
    mesh = JM.make_mesh(JM.MeshSpec(**axes), jax.devices()[:N])
    step = JS.make_gspmd_train_step(
        lambda p, b: JT.loss_fn(p, b, cfg), opt, mesh=mesh,
        param_spec=JT.param_specs(cfg), batch_spec=JT.batch_specs(),
        donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, jparams[name])
    state = opt.init(params)
    losses = []
    for b in _batches(arrays, case):
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
    return np.asarray(losses), _flat(params, "")


def _jax_mesh(kind):
    devs = np.array(jax.devices()[:N])
    if kind == "flat":
        return Mesh(devs, ("hvd",))
    if kind == "hier":
        return Mesh(devs.reshape(2, 2), ("cross", "local"))
    return Mesh(devs.reshape(2, 2), ("dp", "fsdp"))


def _spec(entries):
    return JP(*[tuple(e) if isinstance(e, list) else e for e in entries])


def _jax_rows(sharding, shape):
    """Each device's (of the first four) index into an array of
    ``shape`` under ``sharding``."""
    imap = sharding.devices_indices_map(shape)
    return [imap[d] for d in jax.devices()[:N]]


def _jax_side(jparams, arrays):
    out = {case: _jax_case(case, jparams, arrays) for case in CASES}
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    out["placements"] = [
        [x[i] for i in _jax_rows(NamedSharding(_jax_mesh(m), _spec(s)),
                                 x.shape)]
        for m, s in PLACEMENTS]
    data = {k: arrays[f"loader.{k}"] for k in ("tokens", "targets")}
    out["loader"] = {}
    for name, axes in LOADER_MESHES.items():
        spec = JM.MeshSpec(**axes)
        mesh = Mesh(np.array(jax.devices()[:N]).reshape(spec.shape),
                    JM.AXIS_ORDER)
        sharding = NamedSharding(mesh, JT.batch_specs()["tokens"])
        loader = JDataLoader(data, LOADER_BATCH, seed=7, shard=False,
                             prefetch=0, sharding=sharding)
        batches = [{k: np.asarray(v) for k, v in b.items()}
                   for _, b in zip(range(2), loader)]
        rows = _jax_rows(sharding, (LOADER_BATCH, SMALL["max_seq"]))
        out["loader"][name] = (len(loader), batches, rows)
    out["worker_index.hier"] = np.asarray(jax.jit(JS.shard(
        lambda: jnp.stack([jax.lax.axis_index("cross"),
                           jax.lax.axis_index("local")])[None],
        in_specs=(), out_specs=JP(("cross", "local")),
        mesh=_jax_mesh("hier")))())
    try:
        NamedSharding(_jax_mesh("flat"), JP("foo"))
    except ValueError as e:
        out["error.spec"] = f"ValueError: {e}"
    return out


@pytest.fixture(scope="module")
def gspmd(tmp_path_factory):
    """The ranks' results and the JAX side, computed while they run."""
    tmp = tmp_path_factory.mktemp("gspmd")
    arrays = _inputs()
    jparams = {name: _jax_params(name) for name in CONFIGS}
    spec = {"configs": CONFIGS, "lr": LR, "placements": PLACEMENTS,
            "steps": {c: v[4] for c, v in CASES.items()},
            "loader_meshes": LOADER_MESHES, "loader_batch": LOADER_BATCH,
            "ckpt": str(tmp / "ckpt")}
    np.savez(tmp / "in.npz", spec=json.dumps(spec), **arrays,
             **{k: v for name, p in jparams.items()
                for k, v in _flat(p, f"p{name}.").items()})
    result = {}
    thread = _start_pod(tmp, result)
    jax_out = _jax_side(jparams, arrays)
    thread.join(timeout=330)
    assert not thread.is_alive(), "the four-rank job did not end"
    assert result["rc"] == 0, _logs(tmp / "pod_logs")
    env = dict(os.environ, **_env(tmp), HOROVOD_CROSS_SIZE="2")
    env.pop("HOROVOD_RANK", None)
    env.pop("HOROVOD_SIZE", None)
    single = subprocess.run(
        [sys.executable, str(WORKER), "single", str(tmp / "in.npz"),
         str(tmp)], env=env, capture_output=True, text=True, timeout=300)
    assert single.returncode == 0, single.stdout[-3000:] + \
        single.stderr[-3000:]
    ranks = [dict(np.load(tmp / f"pod.{r}.npz")) for r in range(N)]
    return {"ranks": ranks, "single": dict(np.load(tmp / "single.0.npz")),
            "jax": jax_out, "arrays": arrays}


def _params(res, prefix):
    pre = prefix + "."
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _hold_to_jax(res, case, want):
    jloss, jparams = want
    np.testing.assert_allclose(res[f"{case}.losses"], jloss, rtol=LOSS_RTOL)
    got = _params(res, f"{case}.param")
    assert set(got) == set(jparams)
    for name, value in jparams.items():
        np.testing.assert_allclose(got[name], value, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)


# --- (a)-(c): the GSPMD step against JAX's -----------------------------------


@pytest.mark.parametrize("case,impl", [("a", "reference"), ("a", "flash"),
                                       ("b", "reference")])
def test_gspmd_step_matches_jax(gspmd, case, impl):
    """dp 2 x tp 2 (SGD; ``flash``: K1-K3's plain versions under
    ``local_map`` on the CPU) and fsdp 2 x tp 2 (Adam), two steps: the
    losses and every parameter, on every rank."""
    key = case if impl == "reference" else f"{case}_flash"
    for res in gspmd["ranks"]:
        _hold_to_jax(res, key, gspmd["jax"][case])


def test_fsdp_shards_parameter_and_optimizer_bytes(gspmd):
    """The ZeRO-3 claim, as ``tests/test_models.py:482-493``: a rank's
    bytes of parameters and Adam state at fsdp 2 x tp 2 are between 0.4
    and 0.6 of dp 2 x tp 2's."""
    for res in gspmd["ranks"]:
        ratio = float(res["b.bytes"]) / float(res["h.bytes"])
        assert 0.4 < ratio < 0.6, ratio


def test_sp_tp_moe_step_matches_jax(gspmd):
    """sp 2 x tp 2 with two experts (switch dispatch at JAX's global
    capacity): the loss of one step and the parameters after it."""
    for res in gspmd["ranks"]:
        _hold_to_jax(res, "c", gspmd["jax"]["c"])


def test_size_one_equals_make_train_step(gspmd):
    """(d): one process, AdamW, two steps: the GSPMD step's losses and
    parameters equal ``make_train_step``'s bit for bit."""
    res = gspmd["single"]
    for impl in ("reference", "flash"):
        assert np.array_equal(res[f"d.{impl}.gspmd"], res[f"d.{impl}.ref"])
        assert bool(res[f"d.{impl}.equal"]), impl


# --- (e), (f): the basics meshes ---------------------------------------------


def test_worker_index_under_run(gspmd):
    for res in gspmd["ranks"]:
        np.testing.assert_array_equal(res["worker_index"], np.arange(N))
        np.testing.assert_array_equal(res["worker_index.hier"],
                                      gspmd["jax"]["worker_index.hier"])
        assert str(res["error.unbound"]).startswith(
            "NameError: Found an unbound axis name: hvd")


def test_basics_meshes_over_four_ranks(gspmd):
    for res in gspmd["ranks"]:
        np.testing.assert_array_equal(res["mesh"], np.arange(N))
        assert list(res["mesh.names"]) == ["hvd"]
        np.testing.assert_array_equal(res["hier"],
                                      np.arange(N).reshape(2, 2))
        assert list(res["hier.names"]) == ["cross", "local"]
        assert str(res["axis_name"]) == "hvd"
        assert list(res["sharding_for"]) == ["(Shard(dim=0),)",
                                             "(Shard(dim=1), Shard(dim=1))"]


@pytest.mark.parametrize("i", range(len(PLACEMENTS)))
def test_spec_placement_matches_jax(gspmd, i):
    """Rank ``r``'s shard of an (8, 4) array under a spec equals what
    JAX's ``NamedSharding`` gives device ``r``."""
    for r, res in enumerate(gspmd["ranks"]):
        np.testing.assert_array_equal(res[f"placement.{i}"],
                                      gspmd["jax"]["placements"][i][r])


def test_errors(gspmd):
    """A bad spec (JAX's text), an axis split out of the mesh's order, no
    hierarchical mesh (JAX's text), use before ``init``; and pp > 1 /
    ep > 1 in the GSPMD step, which run: dp 2 x pp 2 on (a)'s batches and
    dp 2 x ep 2 on (c)'s give JAX's (a) and (c) losses and parameters
    (the step's result does not depend on the mesh)."""
    res = gspmd["ranks"][0]
    assert str(res["error.spec"]) == gspmd["jax"]["error.spec"]
    assert str(res["error.order"]).startswith("ValueError: PartitionSpec(("
                                              "'local', 'cross'),)")
    for rank in gspmd["ranks"]:
        _hold_to_jax(rank, "a_pp", gspmd["jax"]["a"])
        _hold_to_jax(rank, "c_ep", gspmd["jax"]["c"])
    single = gspmd["single"]
    assert bool(single["hier_is_none"])
    assert str(single["error.hier"]) == \
        "ValueError: hierarchical mesh unavailable (heterogeneous hosts)"
    for name in ("mesh", "hierarchical_mesh", "axis_name", "sharding_for",
                 "worker_index"):
        assert str(single[f"error.uninit.{name}"]).startswith(
            "NotInitializedError"), name


def test_shard_and_placement_helpers(gspmd):
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    for r, res in enumerate(gspmd["ranks"]):
        np.testing.assert_array_equal(res["shard.a"], x * 10 + 3)
        np.testing.assert_array_equal(res["shard.b"], np.ones(3 * N))
        np.testing.assert_array_equal(res["shard_batch"],
                                      x[2 * r:2 * r + 2])


# --- (g): the DataLoader's pod mode ------------------------------------------


@pytest.mark.parametrize("mesh", list(LOADER_MESHES))
def test_loader_rows_match_jax(gspmd, mesh):
    """Rank ``r``'s rows of each global batch are JAX's rows of device
    ``r`` (the same permutation on every rank), and the global batch is
    JAX's."""
    n, batches, rows = gspmd["jax"]["loader"][mesh]
    for r, res in enumerate(gspmd["ranks"]):
        assert int(res[f"loader.{mesh}.len"]) == n
        for i, b in enumerate(batches):
            np.testing.assert_array_equal(res[f"loader.{mesh}.{i}.full"],
                                          b["tokens"])
            np.testing.assert_array_equal(res[f"loader.{mesh}.{i}.targets"],
                                          b["targets"])
            np.testing.assert_array_equal(res[f"loader.{mesh}.{i}.local"],
                                          b["tokens"][rows[r]])


def test_loader_feeds_the_gspmd_step(gspmd):
    """The loader's DTensor batch (each rank's rows) gives the GSPMD step
    the loss of the same global batch given plain."""
    for res in gspmd["ranks"]:
        assert res["loader.step.loader"] == res["loader.step.plain"]


def test_loader_inner_split_raises_jax_text(gspmd):
    assert str(gspmd["ranks"][0]["error.loader"]) == (
        "ValueError: global DataLoader: only the leading batch dim may be "
        "sharded across processes (dim 1 of 'tokens' is process-partitioned)")


# --- (h): pod checkpoints ----------------------------------------------------


def _saved(res):
    return _params(res, "saved")


def test_pod_checkpoint_same_layout_replays_bit_for_bit(gspmd):
    """Saved by four ranks at dp 2 x tp 2 after step 1 (every rank its
    shards), restored into the live tensors: step 2 replays bit for
    bit; CheckpointManager's pod branches write, rename and restore."""
    for res in gspmd["ranks"]:
        assert bool(res["h.spans"])
        assert int(res["h.same.step"]) == 1
        assert res["h.same.replay"] == res["h.losses"][1]
        assert list(res["h.mgr"]) == [3, 3] and bool(res["h.mgr.equal"])


@pytest.mark.parametrize("where", ["fsdp", "single"])
def test_pod_checkpoint_restores_into_another_layout(gspmd, where):
    """Restored into fsdp 2 x tp 2 (four ranks) and into a one-process
    job: every full parameter and Adam moment equals the saved one bit
    for bit, and the resumed step's loss is within the GSPMD tolerance
    of the writer's."""
    saved = _saved(gspmd["ranks"][0])
    readers = gspmd["ranks"] if where == "fsdp" else [gspmd["single"]]
    for res in readers:
        got = _params(res, f"h.{where}")
        assert set(got) == set(saved)
        for name, value in saved.items():
            assert np.array_equal(got[name], value), name
        np.testing.assert_allclose(res[f"h.resumed.{where}"],
                                   gspmd["ranks"][0]["h.losses"][1],
                                   rtol=LOSS_RTOL)
    if where == "single":
        assert bool(gspmd["single"]["async.equal"])
