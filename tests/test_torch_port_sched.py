"""The port's priority classes and preemption against the JAX engine, on
the CPU at f32.

Following ``tests/test_sched.py`` (preemption, priority plumbing) and
``tests/test_paged.py`` (decode growth past the pool): the same stepped
scenario runs through both engines from one set of weights and must
give the same record (tokens or typed errors, finish reasons, the
preemption, resume and restart counters).  A preempted request is
suspended, not failed: it resumes from its journal frontier and its
tokens equal an uninterrupted run's.  Slot pressure suspends only a
strictly worse class; a page shortage during decode growth suspends the
youngest request of the worst class; with ``resume=False`` the victim
fails with ``CacheOutOfPagesError``.  Over HTTP the ``"priority"`` field
is honoured and an unknown class is a 400.

Most scenarios run on one lent pair of engines (:data:`POOL`: two slots
over a four-page pool) and read their counters as differences."""

import pytest
import torch

from horovod_tpu import serving as JS
from horovod_tpu_torch import serving as TS

from conftest import http_post_json
from torch_port_parity import (
    BASE,
    counters,
    make_engine,
    make_model,
    oracle,
    outcome,
    run,
    run_both,
)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    return make_model()


#: The lent engines' configuration: two slots, four pages of eight.
POOL = dict(n_slots=2, n_pages=4, overlap=True)


def _snapshot(engine) -> dict:
    st = engine.stats()
    return {"stats": counters(engine),
            "ttft": {k: v["count"]
                     for k, v in st["ttft_seconds_by_class"].items()},
            "wait": {k: v["count"]
                     for k, v in st["queue_wait_seconds_by_class"].items()}}


def _record(engine, futs, before, **more):
    """What the scenario did since ``before`` (a :func:`_snapshot`):
    outcomes, counters and the per-class TTFT and queue-wait counts."""
    now, st = _snapshot(engine), engine.stats()

    def grown(key):
        return {c: n - before[key].get(c, 0) for c, n in now[key].items()
                if n > before[key].get(c, 0)}

    return {"futs": [outcome(f) for f in futs],
            "stats": counters(engine, since=before["stats"]),
            "slots_active": st["slots_active"],
            "pages_free": (st["kv_pages_free"], st["kv_pages_total"]),
            "ttft_by_class": grown("ttft"),
            "queue_wait_by_class": grown("wait"), **more}


class TestSlotPressure:
    def test_batch_occupant_suspends_for_interactive(self, model):
        """Every slot busy with batch work and an interactive arrival:
        the youngest batch occupant is suspended, the interactive
        request admits at once, and the victim's tokens equal an
        uninterrupted run's."""

        def scenario(S, make):
            engine = make()
            before = _snapshot(engine)
            b1 = engine.submit([1, 2, 3], max_new_tokens=12,
                               priority="batch")
            b2 = engine.submit([4, 5, 6], max_new_tokens=12,
                               priority="batch", temperature=1.1, seed=9)
            for _ in range(6):
                engine.step()
            inter = engine.submit([7, 8, 9], max_new_tokens=3)
            ticks = 0
            while not inter.done():
                engine.step()
                ticks += 1
            waiting = (b1.done(), b2.done())
            run(engine, [b1, b2])
            return _record(engine, [b1, b2, inter], before, ticks=ticks,
                           waiting=waiting)

        rec = run_both(model, scenario, shared=True, **POOL)
        assert rec["ticks"] <= 4 and rec["waiting"] == (False, False)
        assert rec["futs"] == [
            ("ok", oracle(model, [1, 2, 3], 12), "length"),
            ("ok", oracle(model, [4, 5, 6], 12, temperature=1.1, seed=9),
             "length"),
            ("ok", oracle(model, [7, 8, 9], 3), "length")]
        st = rec["stats"]
        assert st["preemptions"] == 1 and st["engine_restarts"] == 0
        assert st["resume_wasted_tokens"] >= 3 + 6
        # each class observed one TTFT per request, the victim's once
        assert rec["ttft_by_class"] == {"batch": 2, "interactive": 1}
        assert rec["queue_wait_by_class"] == {"batch": 2, "interactive": 1}

    def test_no_preemption_within_a_class(self, model):
        """Both slots and every page held by interactive requests, and an
        interactive arrival: it waits for a slot and pages; nothing is
        suspended."""

        def scenario(S, make):
            engine = make()
            before = _snapshot(engine)
            first = engine.submit([1, 2, 3], max_new_tokens=12)
            other = engine.submit([6, 7, 8], max_new_tokens=12)
            for _ in range(4):
                engine.step()
            second = engine.submit([4, 5], max_new_tokens=2)
            run(engine, [first, other, second])
            return _record(engine, [first, other, second], before)

        rec = run_both(model, scenario, shared=True, **POOL)
        assert rec["stats"]["preemptions"] == 0
        assert rec["futs"] == [
            ("ok", oracle(model, [1, 2, 3], 12), "length"),
            ("ok", oracle(model, [6, 7, 8], 12), "length"),
            ("ok", oracle(model, [4, 5], 2), "length")]


OLD = [3, 4, 5, 6, 7, 8, 9, 1]
YOUNG = [2, 6, 4, 1, 9, 5, 8, 3]


class TestPagePressure:
    @pytest.mark.parametrize("overlap", [True, False],
                             ids=["overlap", "sync"])
    def test_growth_past_the_pool_suspends_the_youngest(self, model,
                                                        overlap):
        """Two requests that each need the whole four-page pool: decode
        growth runs out of pages and the younger one is suspended (not
        failed), resumed when the older retires, and both equal the
        oracle; nothing leaks."""

        def scenario(S, make):
            engine = make()
            before = _snapshot(engine)
            old = engine.submit(OLD, max_new_tokens=24)
            young = engine.submit(YOUNG, max_new_tokens=24,
                                  temperature=0.7, top_p=0.9, seed=4)
            run(engine, [old, young])
            return _record(engine, [old, young], before)

        rec = run_both(model, scenario, shared=True,
                       **{**POOL, "overlap": overlap})
        assert rec["futs"] == [
            ("ok", oracle(model, OLD, 24), "length"),
            ("ok", oracle(model, YOUNG, 24, temperature=0.7, top_p=0.9,
                          seed=4), "length")]
        assert rec["stats"]["preemptions"] >= 1
        assert rec["slots_active"] == 0 and rec["pages_free"] == (4, 4)
        assert rec["stats"]["journal_inflight"] == 0

    def test_growth_past_the_pool_without_resume_fails_typed(self, model):
        def scenario(S, make):
            engine = make(n_slots=2, n_pages=4, overlap=False, resume=False)
            before = _snapshot(engine)
            old = engine.submit(OLD, max_new_tokens=24)
            young = engine.submit(YOUNG, max_new_tokens=24)
            run(engine, [old, young])
            return _record(engine, [old, young], before)

        rec = run_both(model, scenario)
        assert rec["futs"][0] == ("ok", oracle(model, OLD, 24), "length")
        assert rec["futs"][1][:2] == ("err", "CacheOutOfPagesError")
        assert rec["stats"]["preemptions"] == 0

    def test_waiting_interactive_head_suspends_a_batch_occupant(self,
                                                                model):
        """A slot is free but the pool is not: the interactive head of
        the queue cannot get its pages while a batch request holds
        them, so the batch request is suspended; the interactive one
        admits on the next tick, and both equal the oracle."""

        def scenario(S, make):
            engine = make()
            before = _snapshot(engine)
            batch = engine.submit(OLD, max_new_tokens=24, priority="batch")
            for _ in range(12):  # grows into its third page
                engine.step()
            inter = engine.submit(list(range(1, 17)), max_new_tokens=4)
            run(engine, [batch, inter])
            return _record(engine, [batch, inter], before)

        rec = run_both(model, scenario, shared=True, **POOL)
        assert rec["futs"] == [
            ("ok", oracle(model, OLD, 24), "length"),
            ("ok", oracle(model, list(range(1, 17)), 4), "length")]
        assert rec["stats"]["preemptions"] == 1


class TestPriority:
    def test_class_survives_a_restart(self, model):
        """A batch request interrupted by a crash resumes as batch (the
        journal and the resume carry the class); its TTFT and queue wait
        are observed once."""

        def scenario(S, make):
            engine = make()
            before = _snapshot(engine)
            inj = engine.engine_cfg.faults
            inj.add(S.FaultSpec(site="decode_tick", kind="raise",
                                skip=inj.visits("decode_tick") + 6))
            fut = engine.submit([1, 2, 3], max_new_tokens=10,
                                priority="batch")
            run(engine, [fut])
            return _record(engine, [fut], before)

        rec = run_both(model, scenario, shared=True, **POOL)
        assert rec["futs"] == [("ok", oracle(model, [1, 2, 3], 10),
                                "length")]
        st = rec["stats"]
        assert (st["engine_restarts"], st["requests_resumed"]) == (1, 1)
        assert rec["ttft_by_class"] == {"batch": 1}
        assert rec["queue_wait_by_class"] == {"batch": 1}

    @pytest.mark.parametrize("S", [JS, TS], ids=["jax", "port"])
    def test_unknown_class_is_a_typed_rejection(self, model, S):
        engine = make_engine(model, "jax" if S is JS else "port", **BASE)
        with pytest.raises(S.ServingError, match="priority"):
            engine.submit([1], max_new_tokens=1, priority="platinum")
        assert engine.scheduler.depth == 0 and len(engine.journal) == 0

    def test_http_priority_roundtrip_and_400(self, model):
        engine = make_engine(model, "port", **BASE)
        srv = TS.ServingServer(engine, port=0).start()
        try:
            url = "http://%s:%d/generate" % srv.address
            code, out = http_post_json(url, {"tokens": [1, 2],
                                             "max_new_tokens": 2,
                                             "priority": "batch"})
            assert code == 200
            assert out["tokens"] == oracle(model, [1, 2], 2)
            by_class = engine.stats()["ttft_seconds_by_class"]
            assert by_class["batch"]["count"] == 1
            assert "interactive" not in by_class
            code, out = http_post_json(url, {"tokens": [1, 2],
                                             "priority": "platinum"})
            assert code == 400 and "priority" in out["error"]
        finally:
            srv.stop(drain_timeout=10)
