"""The port's slot-contiguous serving path and its ``paged_kernel`` knob
against the JAX package, on the CPU at f32.

Following ``tests/test_serving.py`` (the slot cache, ``decode_step_slots``,
the ``paged=False`` engine) and ``tests/test_paged.py`` (the
``paged_kernel`` knob), at the tiny shapes of
``tests/torch_port_parity.py`` (vocab 64, d_model 32, 4 heads over 2 kv
heads, 2 layers), weights drawn with numpy and shared through
``params_from_jax``:

* the model functions on the same seeded inputs: ``decode_step_slots``
  over three ticks of changing active masks, an inactive row and a slot
  whose old tenant was longer (logits and cache within 1e-5, positions
  equal); its capacity guard (the same ``ValueError``);
  ``insert_prefill`` / ``insert_prefill_batch`` (exact); ``SlotCache``'s
  allocation order.
* whole engines (``run_both``): the ``paged=False`` engine's greedy and
  sampled tokens, with the pipeline on and off, equal the JAX
  ``paged=False`` engine's, the oracle's and the port's paged engine's;
  a slot reused by a shorter request; slot-pressure preemption by class;
  a decode fault resumed from the journal; a watchdog stall; the
  restart resets the slot cache in place.  Speculation, chunking and
  prefixes without paging raise the JAX engine's errors.
* ``paged_kernel`` None, True and False give equal tokens, and
  ``paged_kernel_engaged`` resolves as the JAX engine's on the CPU, for
  the plain and the speculative engine; False never calls K4's wrapper.
* ``EngineConfig`` equals the JAX class field for field; ``/stats``
  and ``/metrics`` carry ``paged`` and the page keys as the JAX server
  does.

Torch runs one thread."""

import ast
import json
import re
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu.serving import cache as JC
from horovod_tpu_torch import serving as TS
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import paged_attention as PA
from horovod_tpu_torch.serving import cache as TC

from conftest import http_post_json
from torch_port_parity import (
    counters,
    make_engine,
    make_model,
    oracle,
    outcome,
    run,
    run_both,
    settle,
    wait_for,
)

ROOT = Path(__file__).resolve().parents[1]

#: Logits and K/V of ``decode_step_slots``: f32, summation order only.
ATOL = 1e-5

#: Every unpaged scenario's engine keywords (over ``BASE``).
UNPAGED = dict(paged=False)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    return make_model()


# ---------------------------------------------------------------------------
# the model and the cache
# ---------------------------------------------------------------------------


def _slot_caches(m, S=4, T_=24, seed=0):
    """The same slot cache in both packages: K/V drawn from ``seed``
    (every position filled, so what a slot's old tenant left past its
    position is there to be misread), positions and tokens."""
    rng = np.random.default_rng(seed)
    cfg = m.jcfg
    shape = (cfg.n_layers, S, cfg.n_kv_heads, T_, cfg.d_model // cfg.n_heads)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v),
          "pos": jnp.zeros((S,), jnp.int32)}
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
          "pos": torch.zeros((S,), dtype=torch.int32)}
    return jc, tc, rng


def _close(jc, tc):
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["all_active", "inactive_row",
                                  "reused_slot"])
def test_decode_step_slots_matches_jax(model, case):
    """Three ticks of ``decode_step_slots`` in both packages: the logits
    of active rows within 1e-5, the cache within 1e-5, positions equal.
    ``inactive_row`` leaves a row out (it computes on zeros, keeps its
    position, and its write at the stale position is the JAX package's);
    ``reused_slot`` puts slot 1 back at position 2 after a tenant left
    K/V up to position 20, so a mask wider than ``<= pos`` would read
    it."""
    jc, tc, rng = _slot_caches(model)
    pos = np.array([5, 20, 0, 11], np.int32)
    active = np.array([True, True, True, True])
    if case == "inactive_row":
        active[2] = False
    if case == "reused_slot":
        pos[1] = 2
    jc["pos"] = jnp.asarray(pos)
    tc["pos"] = torch.from_numpy(pos.copy())
    for tick in range(3):
        toks = rng.integers(0, 64, 4).astype(np.int32)
        if case == "inactive_row" and tick == 2:
            active[0] = False
        jl, jc = JT.decode_step_slots(model.jparams, jnp.asarray(toks), jc,
                                      model.jcfg, jnp.asarray(active))
        tl, tc = T.decode_step_slots(model.tparams, torch.from_numpy(toks),
                                     tc, model.tcfg, torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], atol=ATOL, rtol=0)
        _close(jc, tc)


def test_decode_step_slots_capacity_guard(model):
    """An active slot at the cache's end raises the JAX package's
    ``ValueError``; the same slot inactive does not."""
    jc, tc, _ = _slot_caches(model, S=2, T_=8)
    jc["pos"] = jnp.asarray([3, 8], jnp.int32)
    tc["pos"] = torch.tensor([3, 8], dtype=torch.int32)
    toks = np.array([1, 2], np.int32)
    msgs = []
    for fn, args in ((JT.decode_step_slots,
                      (model.jparams, jnp.asarray(toks), jc, model.jcfg,
                       jnp.asarray([True, True]))),
                     (T.decode_step_slots,
                      (model.tparams, torch.from_numpy(toks), tc, model.tcfg,
                       torch.tensor([True, True])))):
        with pytest.raises(ValueError) as e:
            fn(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "past cache capacity" in msgs[0]
    T.decode_step_slots(model.tparams, torch.from_numpy(toks), tc,
                        model.tcfg, torch.tensor([True, False]))


@pytest.mark.parametrize("batch", [False, True])
def test_insert_prefill_matches_jax(model, batch):
    """A prefilled block (random, ``T_pre < T``) lands at position 0 of
    its slots in both packages: the caches bit-equal, every other slot
    untouched, positions adopted."""
    jc, tc, rng = _slot_caches(model, S=4, T_=24, seed=3)
    cfg = model.jcfg
    K = 3 if batch else 1
    shape = (cfg.n_layers, K, cfg.n_kv_heads, 16, cfg.d_model // cfg.n_heads)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    if batch:
        slots = np.array([3, 0, 2], np.int32)
        pos = np.array([16, 9, 1], np.int32)
        jc = JC.insert_prefill_batch(
            jc, jnp.asarray(slots),
            {"k": jnp.asarray(pk), "v": jnp.asarray(pv),
             "pos": jnp.asarray(pos)})
        TC.insert_prefill_batch(
            tc, torch.from_numpy(slots.astype(np.int64)),
            {"k": torch.from_numpy(pk), "v": torch.from_numpy(pv),
             "pos": torch.from_numpy(pos)})
    else:
        jc = JC.insert_prefill(jc, 2, {"k": jnp.asarray(pk),
                                       "v": jnp.asarray(pv),
                                       "pos": jnp.int32(13)})
        TC.insert_prefill(tc, 2, {"k": torch.from_numpy(pk),
                                  "v": torch.from_numpy(pv), "pos": 13})
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


def test_slot_cache_allocation_order(model):
    """``SlotCache`` hands out slots lowest first, reuses the lowest
    freed one, and reports the same counts, mask and positions as the
    JAX class through the same sequence; ``reset`` keeps every tensor
    and zeroes it."""
    jsc = JC.SlotCache(model.jcfg, 4, 16)
    tsc = TC.SlotCache(model.tcfg, 4, 16, device="cpu")
    tensors = {k: v.data_ptr() for k, v in tsc.cache.items()}
    record = {"jax": [], "port": []}
    for name, sc in (("jax", jsc), ("port", tsc)):
        out = record[name]
        out += [sc.alloc() for _ in range(3)]
        sc.free(1)
        sc.free(0)
        out += [sc.alloc(), sc.free_count, sc.active_count, sc.occupancy,
                sc.active_mask().tolist(), sc.alloc(), sc.alloc(),
                sc.alloc(), np.asarray(sc.positions()).tolist()]
        sc.free(1)
        with pytest.raises(ValueError, match="not active"):
            sc.free(1)
        sc.release_all()
        out += [sc.free_count, sc.active_mask().tolist()]
    assert record["port"] == record["jax"]
    assert record["port"][:3] == [0, 1, 2]
    tsc.cache["k"].fill_(1.0)
    tsc.reset()
    assert {k: v.data_ptr() for k, v in tsc.cache.items()} == tensors
    assert all(not v.any() for v in tsc.cache.values())
    assert tsc.free_count == 4


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

#: A staggered mix: a long request, then (as it retires) a shorter one
#: that reuses its slot, sampled requests among them.
REQUESTS = [([3, 5, 7, 9, 11, 13, 15, 17, 19, 21], 20, {}),
            ([11, 2], 8, dict(temperature=0.9, seed=4)),
            ([9, 9, 1, 4], 6, {}),
            ([1, 2], 12, dict(temperature=1.2, top_k=10, top_p=0.9,
                              seed=2)),
            ([40, 41, 42], 9, {})]


def _mix(S, make):
    engine = make()
    before = counters(engine)
    futs = [engine.submit(p, max_new_tokens=n, **kw)
            for p, n, kw in REQUESTS[:3]]
    for _ in range(4):
        engine.step()
    futs += [engine.submit(p, max_new_tokens=n, **kw)
             for p, n, kw in REQUESTS[3:]]
    run(engine, futs)
    st = engine.stats()
    return {"futs": [outcome(f) for f in futs],
            "stats": counters(engine, since=before),
            "paged": st["paged"], "slots_active": st["slots_active"]}


@pytest.mark.parametrize("overlap", [True, False])
def test_unpaged_engine_matches_jax_and_the_paged_engine(model, overlap):
    """The staggered mix through both packages' ``paged=False`` engines:
    the same record; every request's tokens equal its oracle, and the
    port's paged engine gives the same tokens."""
    rec = run_both(model, _mix, shared=True, overlap=overlap, **UNPAGED)
    assert rec["paged"] is False and rec["slots_active"] == 0
    for (p, n, kw), out in zip(REQUESTS, rec["futs"]):
        assert out == ("ok", oracle(model, p, n, **kw), "length")
    paged = _mix(TS, lambda: make_engine(model, "port", n_slots=3,
                                         max_len=40, min_prefill_bucket=4,
                                         overlap=overlap, tick_timeout=0))
    assert paged["futs"] == rec["futs"] and paged["paged"] is True


def test_unpaged_slot_pressure_preempts_by_class(model):
    """Both slots held by batch work and an interactive arrival: the
    slot-contiguous engine suspends the youngest batch occupant, as the
    JAX engine does, and every request's tokens equal its oracle."""

    def scenario(S, make):
        engine = make(n_slots=2)
        before = counters(engine)
        b = [engine.submit([1, 2, 3], max_new_tokens=10, priority="batch"),
             engine.submit([4, 5, 6], max_new_tokens=10, priority="batch",
                           temperature=1.1, seed=9)]
        for _ in range(5):
            engine.step()
        inter = engine.submit([7, 8, 9], max_new_tokens=3)
        run(engine, b + [inter])
        return {"futs": [outcome(f) for f in b + [inter]],
                "stats": counters(engine, since=before)}

    rec = run_both(model, scenario, **UNPAGED)
    assert rec["futs"] == [
        ("ok", oracle(model, [1, 2, 3], 10), "length"),
        ("ok", oracle(model, [4, 5, 6], 10, temperature=1.1, seed=9),
         "length"),
        ("ok", oracle(model, [7, 8, 9], 3), "length")]
    assert rec["stats"]["preemptions"] == 1


@pytest.mark.parametrize("kind", ["raise", "nonfinite"])
def test_unpaged_resume_across_a_fault_equals_the_clean_run(model, kind):
    """A decode tick failing once tokens are out: the slot cache is reset
    in place (the same tensors), every request resumes from the journal,
    and the tokens equal the clean run's and the JAX engine's."""

    def scenario(S, make):
        engine = make()
        inj = engine.engine_cfg.faults
        ptrs = ([t.data_ptr() for t in engine.slots.cache.values()]
                if S is TS else None)
        futs = [engine.submit(p, max_new_tokens=n, **kw)
                for p, n, kw in REQUESTS[:3]]
        for _ in range(5):
            engine.step()
        inj.add(S.FaultSpec(site="decode_tick", kind=kind,
                            skip=inj.visits("decode_tick")))
        run(engine, futs)
        same = (S is not TS or ptrs == [t.data_ptr() for t in
                                        engine.slots.cache.values()])
        return {"futs": [outcome(f) for f in futs],
                "stats": counters(engine), "fired": inj.fired,
                "same_tensors": same}

    rec = run_both(model, scenario, **UNPAGED)
    for (p, n, kw), out in zip(REQUESTS[:3], rec["futs"]):
        assert out == ("ok", oracle(model, p, n, **kw), "length")
    st = rec["stats"]
    assert st["engine_restarts"] == 1 and st["requests_resumed"] == 3
    assert st["journal_inflight"] == 0 and rec["same_tensors"]


def test_unpaged_watchdog_stall_resumes(model):
    """A tick that hangs past ``tick_timeout`` and returns within
    ``stall_grace`` on the slot-contiguous engine: declared stalled,
    restarted, and its requests resume to the oracle, as in the JAX
    engine."""

    def scenario(S, make):
        # Budget and hang three times the first margins (0.3 s, 0.8 s):
        # under the 6-worker tier-1 load a clean tick has outlived 0.3 s.
        engine = make(n_slots=2, tick_timeout=0.9, watchdog_interval=0.02,
                      stall_grace=15.0)
        inj = engine.engine_cfg.faults
        # Every bucket the prompts and their resumes reach: no compile
        # may read as a stall.
        engine.warmup((3, 5, 9))
        warmed = counters(engine)
        inj.add(S.FaultSpec(site="decode_tick", kind="hang", delay=2.4,
                            skip=inj.visits("decode_tick") + 2))
        # Both requests are queued before the loop starts, so the hang
        # finds both in flight at the same tick in either package.
        futs = [engine.submit([11, 12, 13], max_new_tokens=8),
                engine.submit([4, 5], max_new_tokens=6, temperature=0.9,
                              seed=7)]
        engine.start()
        try:
            outs = settle(futs)
            healthy = wait_for(lambda: engine.health == "healthy")
        finally:
            engine.stop()
        return {"futs": outs, "healthy": healthy,
                "stats": counters(engine, since=warmed)}

    rec = run_both(model, scenario, **UNPAGED)
    st = rec["stats"]
    assert rec["futs"] == [
        ("ok", oracle(model, [11, 12, 13], 8), "length"),
        ("ok", oracle(model, [4, 5], 6, temperature=0.9, seed=7),
         "length")], st
    assert (st["engine_restarts"], st["requests_resumed"]) == (1, 2), st
    assert rec["healthy"], st


@pytest.mark.parametrize("what", ["speculative", "prefill_chunk_tokens",
                                  "register_prefix"])
def test_without_paging_raises_as_jax(model, what):
    """Speculation, chunked prefill and shared prefixes need pages: both
    packages raise the same ``ValueError``."""
    errors = []
    for package in ("jax", "port"):
        with pytest.raises(ValueError) as e:
            if what == "register_prefix":
                make_engine(model, package, paged=False).register_prefix(
                    [1, 2, 3])
            else:
                make_engine(model, package, paged=False,
                            **{what: True if what == "speculative" else 8})
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("speculative", [False, True])
@pytest.mark.parametrize("knob", [None, True, False])
def test_paged_kernel_resolves_as_jax_and_keeps_tokens(model, knob,
                                                       speculative,
                                                       monkeypatch):
    """``paged_kernel`` None / True / False: ``paged_kernel_engaged``
    equals the JAX engine's on the CPU (None resolves to the gathered
    pages there); the tokens equal the oracle; K4's wrapper is called
    iff the knob resolved True (on the CPU it runs K4's plain version)."""
    kw = dict(n_slots=3, max_len=40, min_prefill_bucket=4,
              paged_kernel=knob, speculative=speculative, spec_k=3)
    jax_engaged = make_engine(model, "jax", **kw).stats()[
        "paged_kernel_engaged"]
    calls = []
    real = PA.paged_attend

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(PA, "paged_attend", counted)
    engine = make_engine(model, "port", **kw)
    assert engine.stats()["paged_kernel_engaged"] is jax_engaged
    assert jax_engaged is bool(knob)
    futs = [engine.submit(p, max_new_tokens=n, **k)
            for p, n, k in REQUESTS[:4]]
    run(engine, futs)
    for (p, n, k), f in zip(REQUESTS, futs):
        assert f.result(timeout=0) == oracle(model, p, n, **k)
    assert bool(calls) is bool(knob)


def test_engine_config_differs_from_jax_by_tp_alone():
    """The two ``EngineConfig`` classes, field by field (name, annotation,
    default): equal, ``tp`` included (the port lacked it until tensor-
    parallel serving was ported)."""

    def fields(rel):
        tree = ast.parse((ROOT / rel).read_text())
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == "EngineConfig")
        return {n.target.id: (ast.dump(n.annotation), ast.dump(n.value))
                for n in cls.body if isinstance(n, ast.AnnAssign)}

    jax_ = fields("horovod_tpu/serving/engine.py")
    port = fields("horovod_tpu_torch/serving/engine.py")
    assert set(jax_) == set(port)
    assert jax_ == port


#: The ``/stats`` keys a paged engine adds (JAX ``engine.stats``).
PAGE_KEYS = {"page_size", "kv_dtype", "kv_pages_high_water",
             "prefixes_registered", "paged_kernel_engaged"}


@pytest.mark.parametrize("paged", [True, False])
def test_stats_and_metrics_carry_paged(model, paged):
    """``/stats`` has ``paged`` and, on a paged engine only, the page
    keys, as the JAX engine's; ``/metrics`` has the page gauges, at 0
    on the slot-contiguous engine; a request over HTTP equals its
    oracle."""
    jkeys = set(make_engine(model, "jax", paged=paged).stats()) & PAGE_KEYS
    engine = make_engine(model, "port", paged=paged, n_slots=2, max_len=40)
    srv = TS.ServingServer(engine, port=0).start()
    try:
        base = "http://%s:%d" % srv.address
        status, body = http_post_json(base + "/generate",
                                      {"tokens": [5, 6, 7],
                                       "max_new_tokens": 6})
        assert status == 200
        assert body["tokens"] == oracle(model, [5, 6, 7], 6)
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
    finally:
        srv.stop()
    assert stats["paged"] is paged
    assert set(stats) & PAGE_KEYS == jkeys
    assert (set(stats) & PAGE_KEYS == PAGE_KEYS) is paged
    total = float(re.search(r"^serving_kv_pages_total (\S+)$", metrics,
                            re.M).group(1))
    assert (total > 0) is paged
