"""The port's watchdog, journal and HTTP failure contract, on the CPU at
f32.

* The watchdog (``tick_timeout`` of a few tenths of a second, bounded
  waits) against the JAX engine: a tick that hangs and returns within
  ``stall_grace`` resumes its requests to the oracle; one that outlives
  the grace resolves every request with ``EngineStalledError`` before
  the hang ends, and the engine recovers.
* The journal: ``faults.py`` and ``journal.py`` stay verbatim copies of
  the JAX package's; a journal file the port's engine wrote reads the
  same through the JAX package's ``RequestJournal.read_live`` as
  through the port's; resolution purges it.
* HTTP: ``/healthz`` answers 200 while ``degraded``; a request the
  engine failed in flight gets the resume descriptor, in the 503 body
  and in the streamed ``error`` event."""

import ast
import http.client
import json
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from horovod_tpu import serving as JS
from horovod_tpu_torch import serving as TS
from horovod_tpu_torch.serving import sse

from conftest import http_post_json
from torch_port_parity import (
    BASE,
    counters,
    make_engine,
    make_model,
    oracle,
    run,
    run_both,
    settle,
    step_until,
    wait_for,
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


def _stall(*, hang, tick_timeout, stall_grace, requests, warm):
    """A scenario: a warmed engine under its watchdog, a decode tick
    that hangs ``hang`` seconds two ticks into ``requests``, then one
    more request once the engine is healthy again.  The tests' budgets
    and hangs are three times their first ones: under the 6-worker
    tier-1 load a clean tick has outlived a 0.3 s budget."""

    def scenario(S, make):
        engine = make(n_slots=2, tick_timeout=tick_timeout,
                      watchdog_interval=0.02, stall_grace=stall_grace)
        inj = engine.engine_cfg.faults
        engine.warmup(warm)  # no compile may read as a stall
        warmed = counters(engine)
        inj.add(S.FaultSpec(site="decode_tick", kind="hang", delay=hang,
                            skip=inj.visits("decode_tick") + 2))
        # The requests are queued before the loop starts, so the hang
        # finds the same ones in flight at the same tick in either
        # package (submitted after the start, a late request could miss
        # the hang, or meet it with fewer tokens, on a loaded host).
        t0 = time.monotonic()
        futs = [engine.submit(p, max_new_tokens=n, **kw)
                for p, n, kw in requests]
        engine.start()
        try:
            outs = settle(futs)
            early = time.monotonic() - t0 < hang
            # Resolution purges the journal just after it wakes a waiter.
            purged = wait_for(
                lambda: engine.stats()["journal_inflight"] == 0, timeout=1)
            healthy = wait_for(lambda: engine.health == "healthy")
            after = settle([engine.submit([11, 12], max_new_tokens=5)])
        finally:
            engine.stop()  # counters are read with the loop stopped
        return {"futs": outs, "after": after, "healthy": healthy,
                "early": early, "purged": purged,
                "stats": counters(engine, since=warmed)}

    return scenario


class TestWatchdog:
    def test_stall_within_grace_resumes(self, model):
        """A tick hangs past ``tick_timeout`` and returns within
        ``stall_grace``: the watchdog declares the stall (``failed``)
        but holds the futures, the supervised restart resumes them, and
        their tokens equal the oracle's."""
        requests = [([11, 12, 13], 8, {}),
                    ([4, 5], 6, dict(temperature=0.9, seed=7))]
        rec = run_both(model, _stall(hang=2.4, tick_timeout=0.9,
                                     stall_grace=15.0, requests=requests,
                                     warm=(3, 5, 9)))
        st = rec["stats"]
        for (p, n, kw), out in zip(requests, rec["futs"]):
            assert out == ("ok", oracle(model, p, n, **kw), "length"), st
        assert rec["after"] == [("ok", oracle(model, [11, 12], 5),
                                 "length")], st
        assert (st["engine_failures"], st["engine_restarts"],
                st["requests_resumed"]) == (1, 1, 2), st
        assert st["state_transitions"] == ["healthy", "failed", "degraded",
                                           "healthy"], st
        assert rec["healthy"] and st["journal_inflight"] == 0, st

    def test_stall_past_grace_hard_fails_bounded(self, model):
        """A hang that outlives budget + grace: every future — in
        flight and queued — resolves with ``EngineStalledError`` before
        the hang ends, the journal is empty (nothing left to resume when
        the tick returns), and the engine recovers to the oracle."""
        requests = [([11, 12, 13], 30, {}), ([14, 15], 30, {}),
                    ([16], 30, dict(temperature=1.0, seed=1))]
        rec = run_both(model, _stall(hang=3.6, tick_timeout=0.6,
                                     stall_grace=0.6, requests=requests,
                                     warm=(3,)))
        st = rec["stats"]
        assert [o[:2] for o in rec["futs"]] == \
            [("err", "EngineStalledError")] * 3, st
        assert rec["early"] and rec["purged"], st
        assert rec["after"] == [("ok", oracle(model, [11, 12], 5),
                                 "length")], st
        assert (st["engine_failures"], st["engine_restarts"],
                st["requests_resumed"]) == (1, 1, 0), st
        assert rec["healthy"], st


class TestJournal:
    @pytest.mark.parametrize("name", ["faults", "journal"])
    def test_copies_stay_verbatim(self, name):
        """The port's ``serving/<name>.py`` is the JAX package's, code for
        code (only the module docstring differs): the same sites fire on
        the same visits, the same journal lines are written and read."""
        root = Path(__file__).resolve().parents[1]

        def code(pkg):
            tree = ast.parse((root / pkg / "serving" / f"{name}.py")
                             .read_text())
            tree.body = tree.body[1:]  # the module docstring
            return ast.dump(tree)

        assert code("horovod_tpu_torch") == code("horovod_tpu")

    def test_injector_fires_on_the_same_visits(self):
        def drive(S):
            inj = S.FaultInjector([
                S.FaultSpec(site="decode_tick", kind="raise", skip=1,
                            max_fires=2, p=0.5),
                S.FaultSpec(site="decode_fetch", kind="nonfinite", skip=3)],
                seed=42)
            seen = []
            for _ in range(20):
                for site in ("decode_tick", "prefill", "decode_fetch"):
                    try:
                        seen.append(inj.probe(site))
                    except S.InjectedFaultError:
                        seen.append("raised")
            return seen, inj.fired, inj.exhausted

        assert drive(TS) == drive(JS)

    def test_journal_file_reads_the_same_in_both_packages(self, model,
                                                          tmp_path):
        """The port's engine writes its journal file (``journal_path``)
        through a crash and a resume; the JAX package's ``read_live``
        gives what the port's gives — each live request under its trace
        id (the caller's, else the one the engine minted, which its
        future carries), with its emitted tokens (equal to its
        future's), prompt, budget, sampling, class and span id (the
        request's own, its future's ``trace.span_id``) — and nothing
        once every request has resolved."""
        path = str(tmp_path / "journal.jsonl")
        engine = make_engine(model, "port", **BASE, journal_path=path)
        inj = engine.engine_cfg.faults
        futs = [engine.submit([3, 4, 5], max_new_tokens=10,
                              deadline=time.monotonic() + 60,
                              trace_id="client-7"),
                engine.submit([7, 8], max_new_tokens=10, temperature=0.9,
                              top_k=7, seed=11, priority="batch"),
                engine.submit([9, 9], max_new_tokens=10)]
        step_until(engine, lambda: len(futs[1].tokens_so_far()) >= 2)
        inj.add(TS.FaultSpec(site="decode_tick", kind="raise",
                             skip=inj.visits("decode_tick")))
        step_until(engine, lambda: len(futs[1].tokens_so_far()) >= 5)
        assert engine.stats()["engine_restarts"] == 1
        port, ref = (S.RequestJournal.read_live(path) for S in (TS, JS))
        left = {k: v.pop("deadline_remaining_ms") for k, v in port.items()}
        left_ref = {k: v.pop("deadline_remaining_ms")
                    for k, v in ref.items()}
        assert port == ref
        first, second, third = (f.trace_id for f in futs)
        assert first == "client-7" and len({first, second, third}) == 3
        assert len(second) == 16 and set(port) == {first, second, third}
        for key, fut, prompt in zip((first, second, third), futs,
                                    ([3, 4, 5], [7, 8], [9, 9])):
            assert port[key]["prompt"] == prompt
            assert port[key]["emitted_tokens"] == fut.tokens_so_far()
            assert port[key]["max_new_tokens"] == 10
            assert port[key]["span_id"] == fut.trace.span_id
        assert (port[first]["priority"], port[first]["temperature"]) == \
            ("interactive", 0.0)
        assert (port[second]["priority"], port[second]["temperature"],
                port[second]["seed"]) == ("batch", 0.9, 11)
        assert 0 < left[first] <= 60000
        assert abs(left[first] - left_ref[first]) < 1e3
        assert left[second] is None and left_ref[second] is None
        with open(path) as f:
            events = [json.loads(line)["e"] for line in f]
        assert "r" in events  # the resume was journaled
        run(engine, futs)
        assert futs[0].result(timeout=0) == oracle(model, [3, 4, 5], 10)
        assert TS.RequestJournal.read_live(path) == {}
        assert JS.RequestJournal.read_live(path) == {}
        assert engine.stats()["journal_inflight"] == 0

    def test_terminate_purges_the_journal(self, model, tmp_path):
        path = str(tmp_path / "journal.jsonl")
        engine = make_engine(model, "port", **BASE, journal_path=path)
        fut = engine.submit([3, 4, 5], max_new_tokens=20)
        step_until(engine, lambda: len(fut.tokens_so_far()) >= 2)
        assert len(engine.journal) == 1
        engine.terminate("operator shutdown")
        with pytest.raises(TS.EngineFailedError):
            fut.result(timeout=0)
        assert len(engine.journal) == 0 and engine.terminal
        with open(path) as f:
            assert [json.loads(line)["e"] for line in f][-1] == "e"


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _failing_engine(model):
    """An engine that fails for good (``max_restarts=0``) on the third
    decode tick after its warmup."""
    engine = make_engine(model, "port", **BASE, max_restarts=0)
    inj = engine.engine_cfg.faults
    engine.warmup((4,))
    inj.add(TS.FaultSpec(site="decode_tick", kind="raise",
                         skip=inj.visits("decode_tick") + 2))
    return engine


class TestHttp:
    def test_healthz_answers_200_while_degraded(self, model):
        """Restarted and not yet proven by a clean tick, the engine
        serves: ``/healthz`` answers 200 ``degraded``.  (The server's
        first tick hangs a moment, so the state lasts long enough to be
        read.)"""
        engine = make_engine(model, "port", **BASE)
        inj = engine.engine_cfg.faults
        fut = engine.submit([1, 2, 3], max_new_tokens=6)
        step_until(engine, lambda: len(fut.tokens_so_far()) >= 1)
        inj.add(TS.FaultSpec(site="decode_tick", kind="raise",
                             skip=inj.visits("decode_tick")))
        step_until(engine, lambda: engine.health == TS.DEGRADED)
        inj.add(TS.FaultSpec(site="watchdog", kind="hang", delay=1.5,
                             skip=inj.visits("watchdog")))
        srv = TS.ServingServer(engine, port=0).start()
        try:
            base = "http://%s:%d" % srv.address
            code, body = _get(base + "/healthz")
            assert (code, body["status"]) == (200, "degraded")
            assert body["engine_restarts"] == 1
            assert fut.result(timeout=30) == oracle(model, [1, 2, 3], 6)
            assert wait_for(lambda: engine.health == TS.HEALTHY)
            code, body = _get(base + "/healthz")
            assert (code, body["status"]) == (200, "healthy")
        finally:
            srv.stop(drain_timeout=10)

    def test_engine_failed_reply_carries_the_resume_descriptor(self, model):
        """A request in flight when the engine fails for good: 503
        ``engine_failed`` with the tokens already emitted (the oracle's
        first ones), the deadline budget left and the failed attempt's
        span id (the one its breakdown names); ``/healthz`` then
        answers 503 ``failed``."""
        engine = _failing_engine(model)
        with TS.ServingServer(engine, port=0, request_timeout=30.0) as srv:
            base = "http://%s:%d" % srv.address
            code, out = http_post_json(
                base + "/generate", {"tokens": [1, 2], "max_new_tokens": 30,
                                     "timeout_ms": 25000})
            assert (code, out["type"]) == (503, "engine_failed")
            res = out["resume"]
            n = len(res["emitted_tokens"])
            assert n >= 1
            assert res["emitted_tokens"] == oracle(model, [1, 2], 30)[:n]
            assert 0 < res["deadline_remaining_ms"] <= 25000
            assert res["span_id"] == out["breakdown"]["span_id"]
            assert len(res["span_id"]) == 16
            code, body = _get(base + "/healthz")
            assert (code, body["status"]) == (503, "failed")
            code, out = http_post_json(base + "/generate", {"tokens": [1]})
            assert (code, out["type"]) == (503, "engine_failed")
            assert "resume" not in out  # refused at submit: nothing ran

    def test_stream_error_event_carries_the_resume_descriptor(self, model):
        """The same in the streamed ``error`` event; the stream's reply
        names the request by the caller's ``X-Trace-Id``."""
        engine = _failing_engine(model)
        with TS.ServingServer(engine, port=0, request_timeout=30.0) as srv:
            c = http.client.HTTPConnection(*srv.address, timeout=30)
            c.request("POST", "/generate", json.dumps(
                {"tokens": [1, 2], "max_new_tokens": 30, "stream": True}),
                {"Content-Type": "application/json",
                 TS.TRACE_ID_HEADER: "client-7"})
            r = c.getresponse()
            assert r.status == 200
            assert r.getheader(TS.TRACE_ID_HEADER) == "client-7"
            events = sse.read_stream(r)
            c.close()
        kind, err = events[-1]
        streamed = [e["token"] for k, e in events[:-1] if k == "token"]
        assert kind == "error" and err["type"] == "engine_failed"
        assert streamed and err["resume"]["emitted_tokens"] == streamed
        assert streamed == oracle(model, [1, 2], 30)[:len(streamed)]
        assert 0 < err["resume"]["deadline_remaining_ms"]
