"""One rank of the port's tensor-parallel serving job on the CPU (gloo),
for ``tests/test_torch_port_tp_serving.py``.

``python torch_port_tp_worker.py IN.npz OUT STORE MODE`` with
``HOROVOD_RANK`` / ``HOROVOD_SIZE`` set.  ``IN.npz`` holds the model's
weights (``t/<path>``, the draft's ``d/<path>``) and a JSON ``spec``;
the rank writes ``OUT.<rank>.json`` (tokens, counters, error texts) and
``OUT.<rank>.npz`` (logits).  Imports the port only.

``MODE`` ``engine`` (two ranks): every case of the spec through one
``EngineConfig(tp=2)`` engine a case, driven the same way on both ranks
(warmup, register_prefix, submits and steps on every rank); then the
served case, where the leader alone takes requests (``engine.submit``
and HTTP through ``ServingServer``) and the follower runs ``start`` /
``stop``; the model-level sharded body (``prefill`` logits and
``greedy_decode`` with margins); and the typed configuration errors.
``MODE`` ``model`` (any size): the model-level body and one engine
churn at tp = the job's size.
"""

import json
import sys
import time
import traceback
import urllib.request

import numpy as np
import torch

torch.set_num_threads(1)

from horovod_tpu_torch import basics, serving  # noqa: E402
from horovod_tpu_torch.models import params_from_jax  # noqa: E402
from horovod_tpu_torch.models import transformer as T  # noqa: E402
from horovod_tpu_torch.serving import sharding as SH  # noqa: E402


def _tree(d, prefix):
    out = {}
    for key in d.files:
        if not key.startswith(prefix):
            continue
        node, parts = out, key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = d[key]
    return out


def _model(d, spec, prefix, n_layers):
    cfg = T.TransformerConfig(**dict(spec["model"], n_layers=n_layers),
                              dtype=torch.float32,
                              attention_impl="flash")
    return params_from_jax(_tree(d, prefix), cfg, device="cpu"), cfg


def _drive(eng, reqs):
    futs = [eng.submit(p, max_new_tokens=n, **kw) for p, n, kw in reqs]
    while not all(f.done() for f in futs):
        eng.step()
    return [f.result() for f in futs]


def _engine(params, cfg, tp, draft=None, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", cfg.max_seq)
    kw.setdefault("max_prefills_per_tick", 2)
    d = draft or (None, None)
    return serving.InferenceEngine(
        params, cfg, serving.EngineConfig(tp=tp, **kw), device="cpu",
        draft_params=d[0], draft_cfg=d[1])


def _case(name, c, model, draft, tp):
    params, cfg = model
    kw = dict(c.get("kw", {}))
    inj = None
    if name == "restart":
        inj = kw["faults"] = serving.FaultInjector()
    eng = _engine(params, cfg, tp, draft if c.get("draft") else None, **kw)
    if c.get("prefix"):
        eng.register_prefix(c["prefix"])
    eng.warmup(c.get("warm", [4]))
    warm = (eng.decode_compilations, sum(eng._graphs.captures.values()))
    if inj is not None:
        inj.add(serving.FaultSpec(site="decode_tick", kind="raise",
                                  skip=inj.visits("decode_tick") + 3))
    out = {"tokens": _drive(eng, [tuple(r) for r in c["reqs"]])}
    out["recompiles"] = [eng.decode_compilations - warm[0],
                         sum(eng._graphs.captures.values()) - warm[1]]
    out["resumed"] = int(eng.metrics.resumed.value)
    out["pages_shared"] = int(eng.slots.pages_shared)
    return out


def _served(model, spec, res):
    """The leader takes every request; the follower serves them through
    its step loop.  Both record their futures' tokens by request id."""
    from horovod_tpu_torch.serving.router.registry import (
        ReplicaEndpoint, ReplicaRegistry)

    params, cfg = model
    eng = _engine(params, cfg, 2)
    eng.warmup([4, 8])
    warm = eng.decode_compilations
    if basics.rank() != 0:
        eng.start()
        eng.stop(timeout=120)
        res["served"] = {f.trace_id: f.result(timeout=0)
                         for f in eng._rep_finished}
        res["served_recompiles"] = eng.decode_compilations - warm
        return
    srv = serving.ServingServer(eng, port=0).start()
    try:
        host, port = srv.address
        futs = [eng.submit(p, max_new_tokens=n, **kw)
                for p, n, kw in spec["mixed"]]
        req = urllib.request.Request(
            f"http://{host}:{port}/generate",
            data=json.dumps({"tokens": [1, 2, 3],
                             "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            res["http"] = [r.status, json.loads(r.read())["tokens"]]
        for f in futs:
            f.result(timeout=60)
        stats = eng.stats()
        res["stats"] = {"tp": stats["tp"], "mesh": stats["mesh"],
                        "gauge": eng.metrics.tp_degree.value,
                        "tp_type": type(stats["tp"]).__name__}
        reg = ReplicaRegistry()
        reg.add(ReplicaEndpoint("r0g0", host, port))
        reg.poll_now()
        st = reg.statuses()[0]
        d = st.as_dict()
        res["registry"] = [st.tp, st.mesh, d["tp"], d["mesh"]]
        res["served"] = {f.trace_id: f.result() for f in futs}
    finally:
        srv.stop(drain_timeout=10.0)
    res["served_recompiles"] = eng.decode_compilations - warm


def _model_body(model, tp, prompt, steps, arrays, key):
    params, cfg = model
    sh = SH.ServingSharding(cfg, tp, device="cpu")
    tparams = sh.shard_params(params)
    cache = T.init_cache(cfg, prompt.shape[0], prompt.shape[1] + steps,
                         device="cpu", params=tparams)
    logits, _ = T.prefill(tparams, prompt, cache, cfg)
    toks, gaps = T.greedy_decode(tparams, prompt, steps, cfg, margins=True)
    arrays[f"{key}.prefill"] = logits.numpy()
    arrays[f"{key}.gaps"] = gaps.numpy()
    return toks.tolist()


def _specs(tree):
    """A tree of NamedShardings as lists of their specs' entries."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_specs(v) for v in tree]
    return list(tree.spec)


def _layouts(model):
    """``ServingSharding``'s named shardings over the two-rank mesh, and
    the local shard shapes ``shard_params`` cuts."""
    params, cfg = model
    sh = SH.ServingSharding(cfg, 2, device="cpu")
    local = sh.shard_params(params)
    return {"params": _specs(sh.param_shardings()),
            "pool": _specs(sh.pool_shardings(True)),
            "prefill_cache": _specs(sh.prefill_cache_shardings()),
            "prefix": _specs(sh.prefix_kv_sharding()),
            "kernel": _specs(list(sh.paged_kernel_shardings(True))),
            "cache": _specs(T.serving_shardings(sh.mesh, cfg)[1]),
            "wq_placements": [[type(p).__name__, getattr(p, "dim", None)]
                              for p in sh.param_shardings()["layers"]["wq"]
                              .placements],
            "local_wq": list(local.shards[0]["layers"]["wq"].shape),
            "index": list(local.index), "describe": sh.describe()}


def _errors(model, spec):
    """Every JAX ``TestTpConfig`` case against a job of two ranks."""
    params, cfg = model
    out = {}

    def typed(name, fn):
        try:
            fn()
            out[name] = ["none", ""]
        except Exception as exc:  # the typed error is the outcome
            out[name] = [type(exc).__name__, str(exc)]

    def kw_model(**kw):
        c = T.TransformerConfig(**dict(spec["model"], **kw),
                                dtype=torch.float32)
        return T.init_params(c, seed=0, device="cpu"), c

    typed("heads", lambda: _engine(params, cfg, 3))
    typed("kv_heads", lambda: _engine(*kw_model(n_heads=4, n_kv_heads=1),
                                      2))
    typed("devices", lambda: _engine(*kw_model(n_heads=16, n_kv_heads=16,
                                               d_model=64), 16))
    typed("paged", lambda: _engine(params, cfg, 2, paged=False))
    typed("zero", lambda: _engine(params, cfg, 0))
    typed("exactly", lambda: SH.make_tp_mesh(2, [0]))
    return out


def main():
    inp, out, store, mode = sys.argv[1:5]
    basics.init(device="cpu", init_method=f"file://{store}")
    rank, size = basics.rank(), basics.size()
    d = np.load(inp)
    spec = json.loads(str(d["spec"]))
    model = _model(d, spec, "t/", spec["model"]["n_layers"])
    draft = _model(d, spec, "d/", 1) if "d/embed" in d.files else None
    res, arrays = {}, {}
    prompt = torch.as_tensor(np.asarray(spec["prompt"]))
    t0 = time.monotonic()
    try:
        if mode == "engine":
            res["errors"] = _errors(model, spec)
            res["layouts"] = _layouts(model)
            res["cases"] = {name: _case(name, c, model, draft, size)
                            for name, c in spec["cases"].items()}
            _served(model, spec, res)
        else:
            res["cases"] = {"mixed": _case("mixed", spec["cases"]["mixed"],
                                           model, None, size)}
        res["model_tokens"] = _model_body(model, size, prompt,
                                          spec["steps"], arrays, "model")
    except BaseException:
        res["error"] = traceback.format_exc()
    res["seconds"] = time.monotonic() - t0
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)
    np.savez(f"{out}.{rank}.npz", **arrays)
    basics.shutdown()


if __name__ == "__main__":
    main()
