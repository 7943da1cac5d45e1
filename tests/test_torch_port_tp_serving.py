"""horovod_tpu_torch's tensor-parallel serving against the JAX package,
on the CPU: ``EngineConfig.tp``, ``serving/sharding.py``, the sharded
model body and the leader's step replication.

One job of two gloo ranks (``tests/torch_port_tp_worker.py``, the port
only) runs every case through ``EngineConfig(tp=2)`` engines, the
served case (the leader alone takes requests, over ``engine.submit``
and HTTP; the follower runs its step loop), the sharded model body and
the typed configuration errors; a second job of four ranks runs the
body and one churn at tp = 4 on a model of four kv heads.  The parent
computes the oracles while the ranks run, on JAX's tiny config
(``tests/test_tp_serving.py``: vocab 64, d 32, 4 heads, 2 kv heads, 2
layers, f32): JAX's tp = 2 engine (over two of the conftest's virtual
devices), JAX's and the port's tp = 1 engines, and the port's virtual
form (every shard in one process).  Each rank's tokens must equal the
other rank's and every oracle's; a follower's futures equal the
leader's; nothing is captured again after warmup.

Tolerances: the virtual form at tp = 2 equals the gloo ranks bit for
bit (a sum of two f32 partials is the same in either order); at tp = 4
gloo's ring sums the partials in another order than the virtual form's
shard order, so the logits agree within 1e-5 (f32; measured ~1e-6) and
the tokens exactly.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import serving as JS
from horovod_tpu.models import transformer as JT
from horovod_tpu.serving import sharding as JSH
from horovod_tpu_torch import serving as TS
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.serving import sharding as SH
from horovod_tpu_torch.serving.router import replica_main as TRM

from torch_port_parity import make_model

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_port_tp_worker.py"

MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=48, n_kv_heads=2)

# JAX's request sets (tests/test_tp_serving.py).
MIXED_REQS = [
    ([1, 2, 3], 6, {}),
    ([5, 6], 7, {"temperature": 0.8, "top_k": 8, "seed": 1}),
    ([7, 8, 9, 10, 11], 8, {}),
    ([2], 6, {"temperature": 1.1, "top_p": 0.9, "seed": 2}),
    ([9, 9, 4], 5, {}),
    ([3, 1], 6, {"temperature": 0.9, "top_k": 4, "top_p": 0.8, "seed": 3}),
]
PREFIX = [7, 3, 5, 9, 2, 4, 6, 8, 1]
LONG = [int(x) for x in np.random.default_rng(0).integers(0, 64, 30)]
CASES = {
    "mixed": {"reqs": MIXED_REQS, "warm": [4, 8]},
    "int8": {"kw": {"kv_dtype": "int8"}, "reqs": MIXED_REQS[:4]},
    "paged_kernel": {"kw": {"kv_dtype": "int8", "paged_kernel": True},
                     "reqs": [([3, 5, 7], 8, {}), ([11, 2], 6, {})]},
    "prefix": {"kw": {"page_size": 4}, "prefix": PREFIX,
               "reqs": [(PREFIX, 6, {}), (PREFIX + [1, 2], 6, {}),
                        (PREFIX + [3], 5, {"temperature": 0.8, "seed": 3}),
                        ([1, 2, 3], 6, {})]},
    "chunked": {"kw": {"prefill_chunk_tokens": 8},
                "reqs": [(LONG, 8, {}), ([1, 2], 6, {})]},
    "spec_ngram": {"kw": {"speculative": True, "spec_k": 3},
                   "reqs": [([5, 6, 5, 6, 5], 8, {}), ([1, 2, 3], 6, {}),
                            ([9, 9], 5, {"temperature": 1.0, "seed": 2})]},
    "spec_model": {"kw": {"speculative": True, "spec_k": 3}, "draft": True,
                   "reqs": [([5, 6, 5, 6, 5], 8, {}), ([1, 2, 3], 6, {}),
                            ([9, 9], 5, {"temperature": 1.0, "seed": 2})]},
    "restart": {"kw": {"resume": True, "restart_backoff": 0.01},
                "reqs": [([3, 4, 5], 10, {}),
                         ([8, 1], 8, {"temperature": 0.9, "seed": 11})]},
}
#: The cases whose pool is int8 (their oracles are int8 engines).
INT8 = ("int8", "paged_kernel")
PROMPT = [[3, 9, 1, 4, 7], [2, 2, 8, 5, 1]]
STEPS = 5
#: The four-rank job's model: four kv heads, so tp = 4 leaves one a rank.
MODEL4 = dict(MODEL, n_kv_heads=4)
TP4_TOL = 1e-5


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _start(tmp, name, n, weights, spec, mode):
    np.savez(tmp / f"{name}.npz", spec=json.dumps(spec), **weights)
    procs = []
    for r in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(n),
                   HOROVOD_NATIVE="0",
                   PYTHONPATH=f"{REPO}{os.pathsep}{REPO / 'tests'}")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(tmp / f"{name}.npz"),
             str(tmp / f"{name}.out"), str(tmp / f"{name}.store"), mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def _wait(procs, tmp, name):
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * len(procs), "\n".join(logs)
    out = []
    for r in range(len(procs)):
        with open(tmp / f"{name}.out.{r}.json") as f:
            res = json.load(f)
        assert "error" not in res, res["error"]
        res["arrays"] = dict(np.load(tmp / f"{name}.out.{r}.npz"))
        out.append(res)
    return out


def _drive(eng, reqs):
    futs = [eng.submit(p, max_new_tokens=n, **kw) for p, n, kw in reqs]
    while not all(f.done() for f in futs):
        eng.step()
    return [[int(t) for t in f.result()] for f in futs]


def _jax_engine(model, tp, **kw):
    return JS.InferenceEngine(model.jparams, model.jcfg, JS.EngineConfig(
        tp=tp, n_slots=4, max_len=48, max_prefills_per_tick=2, **kw))


def _port_engine(model, tp=1, virtual=False, **kw):
    return TS.InferenceEngine(
        model.tparams, model.tcfg, TS.EngineConfig(
            tp=tp, n_slots=4, max_len=48, max_prefills_per_tick=2, **kw),
        device="cpu", _virtual_tp=virtual)


def _oracle_reqs(int8: bool):
    """Every case's requests that one engine of the pool's dtype answers
    (chunking, prefixes, speculation and a restart move no token)."""
    return [r for name, c in CASES.items() if (name in INT8) == int8
            for r in c["reqs"]]


def _oracles(model):
    """JAX's tp = 2 and tp = 1 engines and the port's tp = 1 engines:
    tokens by (prompt, max_new, sampling) key."""
    out = {}
    for int8 in (False, True):
        reqs = _oracle_reqs(int8)
        kw = {"kv_dtype": "int8"} if int8 else {}
        for who, make in (("jax1", lambda: _jax_engine(model, 1, **kw)),
                          ("port1", lambda: _port_engine(model, 1, **kw))):
            eng = make()
            eng.warmup([4])
            for r, toks in zip(reqs, _drive(eng, reqs)):
                out[(who, _key(r))] = toks
    eng = _jax_engine(model, 2)
    eng.warmup([4, 8])
    for r, toks in zip(MIXED_REQS, _drive(eng, MIXED_REQS)):
        out[("jax2", _key(r))] = toks
    return out


def _key(req):
    p, n, kw = req
    return (tuple(p), n, tuple(sorted(kw.items())))


def _virtual(model, model4):
    """The virtual form: tokens of the mixed churn at tp = 2 and of the
    four-kv-head model at tp = 4, and the model body's logits."""
    out = {}
    eng = _port_engine(model, 2, virtual=True)
    eng.warmup([4, 8])
    out["mixed2"] = _drive(eng, MIXED_REQS)
    eng = TS.InferenceEngine(
        model4[0], model4[1], TS.EngineConfig(
            tp=4, n_slots=4, max_len=48, max_prefills_per_tick=2),
        device="cpu", _virtual_tp=True)
    eng.warmup([4, 8])
    out["mixed4"] = _drive(eng, MIXED_REQS)
    prompt = torch.as_tensor(PROMPT)
    for key, (params, cfg), tp in (("tp2", (model.tparams, model.tcfg), 2),
                                   ("tp4", model4, 4)):
        sh = SH.ServingSharding(cfg, tp, device="cpu", virtual=True)
        tparams = sh.shard_params(params)
        cache = T.init_cache(cfg, 2, 5 + STEPS, device="cpu", params=tparams)
        logits, _ = T.prefill(tparams, prompt, cache, cfg)
        toks, gaps = T.greedy_decode(tparams, prompt, STEPS, cfg,
                                     margins=True)
        out[key] = {"prefill": logits.numpy(), "gaps": gaps.numpy(),
                    "tokens": toks.tolist()}
    return out


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    model = make_model(0)
    draft = make_model(1, n_layers=1)
    cfg4 = T.TransformerConfig(**MODEL4, dtype=torch.float32,
                               attention_impl="flash")
    params4 = T.init_params(cfg4, seed=4, device="cpu",
                            param_dtype=torch.float32)
    spec = {"model": MODEL, "cases": CASES, "mixed": MIXED_REQS,
            "prompt": PROMPT, "steps": STEPS}
    weights = {**_flat(jax.tree_util.tree_map(np.asarray, model.jparams),
                       "t/"),
               **_flat(jax.tree_util.tree_map(np.asarray, draft.jparams),
                       "d/")}
    jobs = {"engine": _start(tmp, "engine", 2, weights, spec, "engine"),
            "model4": _start(tmp, "model4", 4,
                             _flat({k: v for k, v in params4.items()}, "t/"),
                             {**spec, "model": MODEL4,
                              "cases": {"mixed": CASES["mixed"]}},
                             "model")}
    try:
        oracles = _oracles(model)
        virtual = _virtual(model, (params4, cfg4))
        jax_greedy = np.asarray(JT.greedy_decode(
            model.jparams, jnp.asarray(PROMPT, jnp.int32), STEPS,
            model.jcfg)).tolist()
        port_greedy = T.greedy_decode(model.tparams, torch.as_tensor(PROMPT),
                                      STEPS, model.tcfg).tolist()
    except BaseException:
        for procs in jobs.values():
            for p in procs:
                p.kill()
        raise
    return {"ranks": _wait(jobs["engine"], tmp, "engine"),
            "ranks4": _wait(jobs["model4"], tmp, "model4"),
            "oracles": oracles, "virtual": virtual,
            "jax_greedy": jax_greedy, "port_greedy": port_greedy,
            "model": model}


# --- typed configuration errors ----------------------------------------------

#: JAX's TestTpConfig cases: the error each raises and its ``match``.
ERRORS = {"heads": "n_heads", "kv_heads": "kv_heads", "devices": "devices",
          "paged": "paged", "zero": ">= 1", "exactly": "exactly"}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_config_errors_are_typed_with_jax_texts(tp, case):
    """Every JAX ``TestTpConfig`` case raises the port's
    ``ShardingConfigError`` at construction in a job of two ranks (tp=16
    on heads that divide: past the devices), matching JAX's text."""
    for rank in tp["ranks"]:
        kind, text = rank["errors"][case]
        assert kind == "ShardingConfigError", (case, kind, text)
        assert ERRORS[case] in text, (case, text)
    assert issubclass(SH.ShardingConfigError, ValueError)
    assert TS.ShardingConfigError is SH.ShardingConfigError


def test_validate_tp_texts_equal_jax():
    """The divisibility texts are JAX's, word for word."""
    jcfg = JT.TransformerConfig(**dict(MODEL, n_kv_heads=1),
                                dtype=jnp.float32)
    tcfg = T.TransformerConfig(**dict(MODEL, n_kv_heads=1),
                               dtype=torch.float32)
    for tp_ in (0, 3, 2):
        with pytest.raises(JSH.ShardingConfigError) as je:
            JSH.validate_tp(jcfg, tp_)
        with pytest.raises(SH.ShardingConfigError) as te:
            SH.validate_tp(tcfg, tp_)
        assert str(te.value) == str(je.value)
    with pytest.raises(SH.ShardingConfigError, match="devices"):
        SH.ensure_devices(2)  # this process is a job of one
    SH.ensure_devices(1)


# --- the spec trees ----------------------------------------------------------


def _spec_tree(x):
    """A tree of either package's PartitionSpecs as plain tuples."""
    if isinstance(x, dict):
        return {k: _spec_tree(v) for k, v in x.items()}
    if isinstance(x, (jax.sharding.PartitionSpec, T.P)):
        return tuple(x)
    return [_spec_tree(e) for e in x]


SPECS = {
    "params": lambda M: M.serving_param_specs(
        M.TransformerConfig(**MODEL)),
    "params_moe": lambda M: M.serving_param_specs(
        M.TransformerConfig(**MODEL, n_experts=4)),
    "cache": lambda M: M.cache_specs(),
    "pool": lambda M: M.paged_pool_specs(False),
    "pool_int8": lambda M: M.paged_pool_specs(True),
    "kernel": lambda M: M.paged_kernel_specs(False),
    "kernel_int8": lambda M: M.paged_kernel_specs(True),
    "prefix": lambda M: M.prefix_kv_specs(),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_trees_match_jax(name):
    """Each spec function equals JAX's, entry for entry."""
    assert _spec_tree(SPECS[name](T)) == _spec_tree(SPECS[name](JT))


def _jax_specs(tree):
    if isinstance(tree, dict):
        return {k: _jax_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_specs(v) for v in tree]
    return list(tree.spec)


def test_serving_sharding_layouts_match_jax(tp):
    """``ServingSharding``'s named shardings over the two-rank mesh equal
    JAX's over two devices, spec for spec (params, the int8 pool, the
    prefill cache, the prefix block, K4's operands and results, the
    cache of ``serving_shardings``); each rank cuts its own heads."""
    jcfg = JT.TransformerConfig(**MODEL, dtype=jnp.float32)
    jsh = JSH.ServingSharding(jcfg, 2, devices=jax.devices()[:2])
    want = {"params": _jax_specs(jsh.param_shardings()),
            "pool": _jax_specs(jsh.pool_shardings(True)),
            "prefill_cache": _jax_specs(jsh.prefill_cache_shardings()),
            "prefix": _jax_specs(jsh.prefix_kv_sharding()),
            "kernel": _jax_specs(list(jsh.paged_kernel_shardings(True))),
            "cache": _jax_specs(JT.serving_shardings(jsh.mesh, jcfg)[1])}
    for r, rank in enumerate(tp["ranks"]):
        got = rank["layouts"]
        for k, v in want.items():
            assert got[k] == json.loads(json.dumps(v)), k
        assert got["wq_placements"] == [["Shard", 2]]
        assert got["local_wq"] == [2, 32, 2, 8] and got["index"] == [r]
        assert got["describe"] == jsh.describe() == "tp=2 devices=cpu:0,1"
    sh = SH.ServingSharding(T.TransformerConfig(**MODEL), 2, device="cpu",
                            virtual=True)
    with pytest.raises(ValueError, match="virtual"):
        sh.param_shardings()


# --- the sharded body --------------------------------------------------------


def test_sharded_greedy_decode_token_identical(tp):
    """tests/test_models.py's sharded greedy decode: the parameters and
    the cache sharded over two gloo ranks give the unsharded tokens
    (the port's and JAX's)."""
    assert tp["port_greedy"] == tp["jax_greedy"]
    for rank in tp["ranks"]:
        assert rank["model_tokens"] == tp["jax_greedy"]
    assert tp["virtual"]["tp2"]["tokens"] == tp["jax_greedy"]


def test_virtual_form_equals_gloo_bit_for_bit_at_tp2(tp):
    """The virtual form (both shards in one process) equals each gloo
    rank bit for bit: prefill logits and every greedy step's margin."""
    v = tp["virtual"]["tp2"]
    for rank in tp["ranks"]:
        a = rank["arrays"]
        assert np.array_equal(a["model.prefill"], v["prefill"])
        assert np.array_equal(a["model.gaps"], v["gaps"])


def test_virtual_form_equals_gloo_at_tp4(tp):
    """At tp = 4 (one kv head a rank) gloo's ring sums the four partials
    in its own order: logits within :data:`TP4_TOL`, tokens equal, the
    engine churn too."""
    v = tp["virtual"]["tp4"]
    for rank in tp["ranks4"]:
        a = rank["arrays"]
        np.testing.assert_allclose(a["model.prefill"], v["prefill"],
                                   atol=TP4_TOL, rtol=0)
        assert rank["model_tokens"] == v["tokens"]
        assert rank["cases"]["mixed"]["tokens"] == tp["virtual"]["mixed4"]
        assert rank["cases"]["mixed"]["recompiles"] == [0, 0]


def test_moe_splits_like_the_dense_mlp():
    """An MoE config under tp: the expert FFNs split on their hidden
    dimension, the router replicated; the virtual tp = 2 prefill (the
    dropless dispatch) and decode (the dense one) give the unsharded
    tokens."""
    cfg = T.TransformerConfig(**MODEL, n_experts=4, dtype=torch.float32)
    params = T.init_params(cfg, seed=2, device="cpu")
    sh = SH.ServingSharding(cfg, 2, device="cpu", virtual=True)
    prompt = torch.as_tensor(PROMPT)
    want, g0 = T.greedy_decode(params, prompt, STEPS, cfg, margins=True)
    got, g1 = T.greedy_decode(sh.shard_params(params), prompt, STEPS, cfg,
                              margins=True)
    assert torch.equal(got, want)
    assert float((g1 - g0).abs().max()) < 1e-5


# --- the engine --------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_case_token_identical(tp, case):
    """A tp = 2 engine over two gloo ranks: both ranks' tokens equal each
    other, JAX's tp = 1 engine and the port's (JAX's tp = 2 too for the
    mixed churn; the int8 cases against int8 engines), with nothing
    captured or compiled after warmup."""
    c = CASES[case]
    o = tp["oracles"]
    r0, r1 = (r["cases"][case] for r in tp["ranks"])
    assert r0["tokens"] == r1["tokens"]
    for req, toks in zip(c["reqs"], r0["tokens"]):
        key = _key(req)
        assert toks == o[("jax1", key)] == o[("port1", key)], (case, req)
        if case == "mixed":
            assert toks == o[("jax2", key)]
    assert r0["recompiles"] == r1["recompiles"] == [0, 0]
    if case == "restart":
        assert r0["resumed"] >= 1 and r0["resumed"] == r1["resumed"]
    if case == "mixed":
        assert r0["tokens"] == tp["virtual"]["mixed2"]


def test_served_follower_equals_leader(tp):
    """Only the leader takes requests (``submit`` and HTTP, with the
    engine started); the follower serves them through its step loop,
    and its futures (matched by trace id) resolve to the leader's
    tokens, the oracle's; nothing is captured after warmup."""
    lead, fol = tp["ranks"]
    assert lead["served"] and set(lead["served"]) <= set(fol["served"])
    assert len(fol["served"]) == len(lead["served"]) + 1  # the HTTP one
    for tid, toks in lead["served"].items():
        assert fol["served"][tid] == toks
    o = tp["oracles"]
    assert [lead["served"][t] for t in lead["served"]] == [
        o[("jax1", _key(r))] for r in MIXED_REQS]
    assert lead["http"] == [200, o[("jax1", _key(MIXED_REQS[0]))]]
    assert lead["served_recompiles"] == fol["served_recompiles"] == 0


def test_stats_and_registry_carry_tp_and_mesh(tp):
    """``/stats`` gives a typed ``tp`` 2 and a ``mesh`` naming the group,
    the ``serving_tp_degree`` gauge follows it, the registry's poll
    carries both; a tp = 1 engine reports 1 and "" and runs no
    replication."""
    lead = tp["ranks"][0]
    assert lead["stats"] == {"tp": 2, "mesh": "tp=2 devices=cpu:0,1",
                             "gauge": 2, "tp_type": "int"}
    assert lead["registry"][0] == 2 and lead["registry"][2] == 2
    assert "tp=2" in lead["registry"][1] and "tp=2" in lead["registry"][3]
    eng = _port_engine(tp["model"])
    st = eng.stats()
    assert (st["tp"], st["mesh"], eng.metrics.tp_degree.value) == (1, "", 1)
    assert eng._shard is None and eng._rep is None
    v = _port_engine(tp["model"], 2, virtual=True)
    assert v.stats()["mesh"] == "tp=2 devices=cpu:0,0"
    assert v._rep is None
    # The pool holds this process's shards, each its own storage.
    assert [t.shape[2] for t in v.slots.cache["k"]] == [1, 1]
    assert all(t.is_contiguous() for t in v.slots.cache["k"])


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:  # a zombie is dead
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def test_replica_main_tp2_serves_and_dies_with_its_leader(tmp_path):
    """``replica_main --tp 2 --device cpu`` starts a follower rank beside
    itself, serves a request equal to the tp = 1 engine's on the same
    seeded model, and a SIGKILL of the leader leaves no rank running."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serving.router."
         "replica_main", "--port", str(port), "--tp", "2", "--device",
         "cpu", "--seed", "3", "--warm", "4", "--tick-timeout", "0"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    followers = []
    try:
        deadline = time.monotonic() + 120
        line = ""
        while "replica ready" not in line:
            assert time.monotonic() < deadline, "replica never ready"
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "replica exited"
            if line.startswith("tp followers:"):
                followers = [int(p) for p in line.split(":")[1].split()]
        assert len(followers) == 1
        code, body = _post(port, {"tokens": [3, 4, 5], "max_new_tokens": 6})
        params, cfg = TRM.build_model(_replica_args(seed=3), device="cpu")
        eng = TS.InferenceEngine(params, cfg, TS.EngineConfig(
            n_slots=4, max_len=cfg.max_seq), device="cpu")
        assert code == 200 and body["tokens"] == _drive(
            eng, [([3, 4, 5], 6, {})])[0]
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
        deadline = time.monotonic() + 20
        while any(_alive(p) for p in followers):
            assert time.monotonic() < deadline, "a follower outlived it"
            time.sleep(0.1)
    finally:
        proc.kill()
        for p in followers:
            try:
                os.kill(p, signal.SIGKILL)
            except ProcessLookupError:
                pass


def _free_port():
    from horovod_tpu_torch.serving.router import supervisor

    return supervisor._free_port()


def _replica_args(**kw):
    import argparse

    base = dict(seed=0, vocab=64, d_model=32, n_heads=4, n_layers=2,
                d_ff=64, max_seq=48, kv_heads=2)
    base.update(kw)
    return argparse.Namespace(**base)


def test_pool_and_params_split_by_head():
    """``shard_params`` cuts heads, the MLP hidden dimension and the
    vocabulary into contiguous shards and leaves the norms whole;
    ``shard_kv_pool`` cuts a pool by kv head, its ``pos`` shared."""
    cfg = T.TransformerConfig(**MODEL, dtype=torch.float32)
    params = T.init_params(cfg, seed=0, device="cpu")
    sh = SH.ServingSharding(cfg, 2, device="cpu", virtual=True)
    tps = sh.shard_params(params)
    assert [s["layers"]["wq"].shape for s in tps.shards] == [
        (2, 32, 2, 8)] * 2
    assert [s["layers"]["w_down"].shape for s in tps.shards] == [
        (2, 32, 32)] * 2
    assert [s["embed"].shape for s in tps.shards] == [(32, 32)] * 2
    assert [s["head"].shape for s in tps.shards] == [(32, 32)] * 2
    assert tps.shards[0]["ln_f"] is params["ln_f"]
    assert torch.equal(torch.cat([s["layers"]["wk"] for s in tps.shards],
                                 dim=2), params["layers"]["wk"])
    pool = TS.init_page_pool(cfg, 4, 9, 8, "int8", device="cpu")
    shp = T.shard_kv_pool(pool, sh)
    assert shp["pos"] is pool["pos"]
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(torch.cat(shp[name], dim=2), pool[name])
        assert all(t.is_contiguous() for t in shp[name])
    local = TS.init_page_pool(cfg, 4, 9, 8, "int8", device="cpu",
                              sharding=sh)
    assert [t.shape for t in local["k_scale"]] == [(2, 9, 1, 8)] * 2
