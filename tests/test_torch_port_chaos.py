"""The port's supervised engine against the JAX engine, fault for fault,
on the CPU at f32.

The same scenario — the same requests, the same
:class:`~horovod_tpu_torch.serving.FaultSpec` scheduled on the same
site visit — runs through the JAX engine (``horovod_tpu.serving``, with
its own ``FaultInjector``) and the port's, from one set of weights, and
both must give the same record: each future's tokens or typed error and
finish reason, the restart, resume, preemption and failure counters,
and the state trail.  Every request that can resume equals the
per-request oracle (``sample_decode`` at its seed, ``greedy_decode``
for greedy ones) after the fault, with the overlapped pipeline on and
off.  The faults follow ``tests/test_chaos.py``: a raise at
``prefill``, ``decode_tick`` and ``decode_fetch``, non-finite logits,
a failing resume, a spent restart budget, ``resume=False``; and one
the JAX engine cannot meet, a sticky device error that makes the
restart's in-place reset raise."""

import pytest
import torch

from horovod_tpu_torch import serving as TS

from torch_port_parity import (
    BASE,
    counters,
    make_engine,
    make_model,
    oracle,
    outcome,
    run,
    run_both,
    step_until,
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


# (prompt, new tokens, sampling): greedy and sampled, one more request
# than the three slots, unequal prompt buckets.
CASES = [([3, 4, 5], 8, {}),
         ([7, 8], 8, dict(temperature=1.0, seed=3)),
         ([1, 2, 3, 4, 5, 6, 7, 8, 9], 6, {}),
         ([9, 10, 11, 12], 7, dict(temperature=0.8, top_k=5, seed=2))]

OVERLAP = pytest.mark.parametrize("overlap", [True, False],
                                  ids=["overlap", "sync"])


def _fault_at_depth(site, kind, *extra):
    """A scenario: the mixed burst, and once the first request has
    emitted a token, one fault at the next visit of ``site`` (plus
    ``extra`` (site, kind) specs scheduled the same way)."""

    def scenario(S, make):
        engine = make()
        inj = engine.engine_cfg.faults
        before, fired = counters(engine), len(inj.fired)
        futs = [engine.submit(p, max_new_tokens=n, **kw)
                for p, n, kw in CASES]
        step_until(engine, lambda: len(futs[0].tokens_so_far()) >= 1)
        for s, k in ((site, kind),) + extra:
            inj.add(S.FaultSpec(site=s, kind=k, skip=inj.visits(s)))
        run(engine, futs)
        return {"futs": [outcome(f) for f in futs],
                "stats": counters(engine, since=before),
                "fired": inj.fired[fired:], "health": engine.health}

    return scenario


class TestResumeAfterFault:
    @OVERLAP
    @pytest.mark.parametrize("site,kind", [
        ("prefill", "raise"), ("decode_tick", "raise"),
        ("decode_tick", "nonfinite"), ("decode_fetch", "raise")])
    def test_fault_resumes_to_the_oracle(self, model, site, kind, overlap):
        """One fault mid-burst: the engine restarts once, every request
        in flight (and one taken for admission, at ``prefill``) resumes
        from its journal frontier, and every request's tokens equal the
        oracle's.  A tick dispatched but not fetched when the fault
        lands is dropped and recomputed, never retired.  (The engines
        are lent: one pair for each mode serves every site.)"""
        rec = run_both(model, _fault_at_depth(site, kind), shared=True,
                       overlap=overlap)
        for (p, n, kw), (status, toks, reason) in zip(CASES, rec["futs"]):
            assert status == "ok" and reason == "length"
            assert toks == oracle(model, p, n, **kw), (p, kw)
        st = rec["stats"]
        assert rec["fired"][0][:2] == (site, kind)
        assert st["engine_failures"] == st["engine_restarts"] == 1
        assert st["requests_resumed"] >= 1
        assert st["journal_inflight"] == 0
        assert st["state_transitions"] == ["healthy", "degraded", "healthy"]
        assert rec["health"] == "healthy"

    def test_failing_resume_fails_inflight_typed(self, model):
        """A fault in the resume machinery itself (``restart_resume``):
        the restart fails the in-flight requests typed instead of
        replaying state it cannot trust; the queued request is served."""
        rec = run_both(model, _fault_at_depth(
            "decode_tick", "raise", ("restart_resume", "raise")),
            shared=True, overlap=True)
        futs = rec["futs"]
        assert [f[:2] for f in futs[:3]] == [("err", "EngineFailedError")] * 3
        p, n, kw = CASES[3]
        assert futs[3] == ("ok", oracle(model, p, n, **kw), "length")
        st = rec["stats"]
        assert st["requests_resumed"] == 0 and st["engine_restarts"] == 1
        assert st["journal_inflight"] == 0

    def test_resume_off_fails_inflight_and_restarts(self, model):
        """``resume=False``: a decode fault fails the in-flight requests
        typed, the engine restarts, and the next request is served to the
        oracle."""

        def scenario(S, make):
            engine = make(resume=False)
            engine.engine_cfg.faults.add(
                S.FaultSpec(site="decode_tick", kind="raise", skip=1))
            futs = [engine.submit([3, 4, 5], max_new_tokens=8),
                    engine.submit([7, 8], max_new_tokens=8)]
            run(engine, futs)
            after = engine.submit([3, 4, 5], max_new_tokens=8)
            run(engine, [after])
            return {"futs": [outcome(f) for f in futs + [after]],
                    "stats": counters(engine)}

        rec = run_both(model, scenario)
        assert [f[:2] for f in rec["futs"][:2]] == \
            [("err", "EngineFailedError")] * 2
        assert rec["futs"][2] == ("ok", oracle(model, [3, 4, 5], 8),
                                  "length")
        assert rec["stats"]["engine_restarts"] == 1
        assert rec["stats"]["requests_resumed"] == 0

    def test_restart_budget_spent_goes_terminal(self, model):
        """A fault on every tick with ``max_restarts=1``: one restart
        (the request resumes), then terminal ``failed``: in-flight and
        queued futures resolve typed, new submits are refused, the
        engine no longer ticks and reports no phantom occupancy."""

        def scenario(S, make):
            engine = make(max_restarts=1)
            engine.engine_cfg.faults.add(S.FaultSpec(
                site="decode_tick", kind="raise", max_fires=None))
            f1 = engine.submit([1, 2], max_new_tokens=6)
            engine.step()  # failure 1 -> restart, f1 resumed
            mid = (engine.health, f1.done())
            f2 = engine.submit([3, 4], max_new_tokens=6)
            f3 = engine.submit([5, 6, 7, 8, 9], max_new_tokens=6,
                               temperature=1.0, seed=5)
            engine.step()  # failure 2 > budget -> terminal
            try:
                engine.submit([7], max_new_tokens=2)
                refused = None
            except S.ServingError as e:
                refused = type(e).__name__
            return {"mid": mid, "futs": [outcome(f) for f in (f1, f2, f3)],
                    "stats": counters(engine), "refused": refused,
                    "ticks": engine.step(), "terminal": engine.terminal,
                    "slots_active": engine.stats()["slots_active"],
                    "free": engine.slots.free_count}

        rec = run_both(model, scenario)
        assert rec["mid"] == ("degraded", False)
        assert [f[:2] for f in rec["futs"]] == \
            [("err", "EngineFailedError")] * 3
        assert rec["refused"] == "EngineFailedError"
        assert rec["ticks"] is False and rec["terminal"] is True
        assert rec["slots_active"] == 0 and rec["free"] == 3
        st = rec["stats"]
        assert (st["engine_failures"], st["engine_restarts"]) == (2, 1)
        assert st["state_transitions"] == ["healthy", "degraded", "failed"]
        assert st["journal_inflight"] == 0


class TestStickyDeviceError:
    @OVERLAP
    def test_failed_reset_goes_terminal(self, model, overlap):
        """After a sticky CUDA error every call raises, the restart's
        in-place reset included.  The engine must not spend its restart
        budget on it: the first failed reset makes it terminally
        ``failed``, every future resolves with ``EngineFailedError``
        whose cause is the reset's error, and ``step`` never raises."""
        engine = make_engine(model, "port", **BASE, overlap=overlap)
        inj = engine.engine_cfg.faults
        sticky = RuntimeError("CUDA error: an illegal memory access was "
                              "encountered")

        def reset():
            raise sticky

        engine.slots.reset = reset
        futs = [engine.submit(p, max_new_tokens=n, **kw)
                for p, n, kw in CASES]
        step_until(engine, lambda: len(futs[0].tokens_so_far()) >= 1)
        inj.add(TS.FaultSpec(site="decode_tick", kind="raise",
                             skip=inj.visits("decode_tick")))
        run(engine, futs, max_ticks=20)
        for f in futs:
            with pytest.raises(TS.EngineFailedError) as err:
                f.result(timeout=0)
            assert err.value.__cause__ is sticky
        assert engine.health == TS.FAILED and engine.terminal
        st = engine.stats()
        assert (st["engine_failures"], st["engine_restarts"]) == (1, 0)
        assert st["requests_resumed"] == 0 and st["journal_inflight"] == 0
        assert st["slots_active"] == 0 and "restart failed" in st["error"]
        assert engine.step() is False
        with pytest.raises(TS.EngineFailedError):
            engine.submit([1, 2])

