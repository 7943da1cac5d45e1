"""The port's engine and server with tracing on, against the JAX
package's, on the CPU at f32.

* Spans: the same prompts through both engines with span recorders on
  (a request under a parent span, a forced-sampled one, a clean one)
  give the same record kinds per request, event types, retention
  verdicts, breakdown keys, ``decode_ticks`` and tokens; a restart by an
  injected fault puts ``engine_restart`` and ``resume`` on the
  interrupted requests' own spans in both, and the JAX package's
  ``RequestJournal.read_live`` reads the span id from the port's journal.
* Ingress: the four header cases of the JAX package's tests
  (``tests/test_tracing.py``), over the port's server.
* ``/metrics``: strict Prometheus text whose serving families are the
  JAX server's for the same config, less the two it does not port yet
  (``serving_tp_degree``, the ``tuning_*`` autotuner families);
  achieved FLOP/s from ``model_flops_per_token``.
* Overhead: with no tracer a tick adds no host sync; with one, exactly
  three tick-phase emissions a tick and none else (the JAX tests'
  bounds, ``tests/test_obs.py``).
* ``HOROVOD_TIMELINE`` with ``%r`` over two gloo processes: one file a
  rank, which ``obs.merge`` labels ``rank 0`` / ``rank 1``."""

import http.client
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu import serving as JS
from horovod_tpu.obs import tracing as JTR
from horovod_tpu_torch import serving as TS
from horovod_tpu_torch.obs import merge as TMERGE
from horovod_tpu_torch.obs import tracing as TTR
from horovod_tpu_torch.obs.registry import default_registry
from horovod_tpu_torch.serving import sse

from conftest import http_post_json, parse_prometheus_text
from torch_port_parity import BASE, make_engine, make_model, oracle, run

ROOT = Path(__file__).resolve().parents[1]

#: The JAX server's serving families the port does not expose yet: the
#: tensor-parallel degree, with the slice that ports tensor-parallel
#: serving.
NOT_PORTED = {"serving_tp_degree"}

#: Tail sampling that keys on nothing but the request itself: no
#: latency verdict (the JAX engine compiles at first use on the CPU).
SAMPLING = dict(latency_threshold_s=600.0, max_tick_spans=64)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    return make_model()


@pytest.fixture()
def no_tracing():
    """Neither package traces around the test, whatever a test left."""
    for TR in (JTR, TTR):
        TR.stop()
        TR.stop_spans()
    yield
    for TR in (JTR, TTR):
        TR.stop()
        TR.stop_spans()


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _by_request(path, futs):
    """Each future's span records: the kinds in order, the typed events,
    the verdict, the breakdown's keys and counts, the tick spans."""
    lines = _lines(path)
    out = []
    for fut in futs:
        sid, tid = fut.trace.span_id, fut.trace_id
        mine = [l for l in lines
                if l.get("id") == sid or l.get("span") == sid
                or l.get("parent") == sid]
        start = [l for l in mine if l["k"] == "s"]
        fin = [l for l in mine if l["k"] == "f"]
        assert len(start) == 1 and len(fin) == 1, mine
        assert all(l.get("trace", tid) == tid for l in mine)
        b = fin[0]["a"]
        out.append({
            "kinds": [l["k"] for l in mine],
            "parent": start[0].get("parent"),
            "events": [l["type"] for l in mine if l["k"] == "e"],
            "retained": b.get("retained"),
            "breakdown_keys": sorted(b),
            "decode_ticks": b["decode_ticks"], "tokens": b["tokens"],
            "ticks": sum(1 for l in mine
                         if l["k"] == "d" and l["name"] == "tick"),
            "tick_tokens": sum(l["a"]["tokens"] for l in mine
                               if l["k"] == "d" and l["name"] == "tick"),
            "status": fin[0]["status"],
        })
    return out


def _spans_scenario(package, model, tmp, fault=False, **kw):
    """The three requests through one engine of ``package`` with its
    span recorder on; with ``fault``, one decode tick raises once every
    request has a token (``journal_path`` set)."""
    TR, S = (JTR, JS) if package == "jax" else (TTR, TS)
    path = str(tmp / f"{package}.spans.jsonl")
    TR.start_spans(path, proc=package,
                   sampling=TR.SpanSampling(**SAMPLING))
    try:
        engine = make_engine(model, package, **{**BASE, **kw})
        futs = [engine.submit([1, 2, 3], max_new_tokens=6,
                              trace_id="parented", parent_span="a" * 16),
                engine.submit([4, 5], max_new_tokens=5, sampled=True),
                engine.submit([6, 7, 8, 9], max_new_tokens=4,
                              temperature=0.8, seed=3)]
        live = None
        if fault:
            inj = engine.engine_cfg.faults
            for _ in range(400):
                if all(f.tokens_so_far() for f in futs):
                    break
                engine.step()
            # The JAX package's reader, on either package's journal.
            live = JS.RequestJournal.read_live(kw["journal_path"])
            inj.add(S.FaultSpec(site="decode_tick", kind="raise",
                                skip=inj.visits("decode_tick")))
        run(engine, futs)
        stats = engine.stats()
    finally:
        TR.stop_spans()
    return path, futs, stats, live


def test_span_records_match_the_jax_engine(model, tmp_path, no_tracing):
    """Record kinds, events, verdicts, breakdown keys, decode ticks and
    tokens per request: equal between the engines, and right."""
    recs = {}
    for package in ("jax", "port"):
        path, futs, _, _ = _spans_scenario(package, model, tmp_path)
        recs[package] = _by_request(path, futs)
        toks = [f.result(timeout=0) for f in futs]
        assert toks[0] == oracle(model, [1, 2, 3], 6)
        assert toks[1] == oracle(model, [4, 5], 5)
        assert toks[2] == oracle(model, [6, 7, 8, 9], 4, seed=3,
                                 temperature=0.8)
        for f in futs:
            b = f.breakdown()
            assert b["queue_wait_s"] + b["prefill_s"] + b["decode_s"] == \
                pytest.approx(b["total_s"], abs=1e-5)
    assert recs["port"] == recs["jax"]
    parented, forced, clean = recs["port"]
    assert parented["parent"] == "a" * 16
    assert (parented["retained"], forced["retained"],
            clean["retained"]) == (None, "forced", None)
    # a clean request keeps no tick detail, a forced one every tick
    assert clean["ticks"] == 0 and "x" in clean["kinds"]
    assert forced["ticks"] == forced["decode_ticks"] == 4
    assert forced["tick_tokens"] == forced["tokens"] - 1 == 4


def test_restart_puts_events_on_the_interrupted_spans(model, tmp_path,
                                                      no_tracing):
    """An injected decode raise restarts both engines: every in-flight
    request gets ``engine_restart`` then ``resume`` on its own span,
    keeps its detail (``event`` verdict), and its tokens; the journal
    the port wrote names each request's span, read by either package."""
    recs, lives = {}, {}
    for package in ("jax", "port"):
        jp = str(tmp_path / f"{package}.journal.jsonl")
        path, futs, stats, live = _spans_scenario(
            package, model, tmp_path, fault=True, journal_path=jp)
        assert stats["engine_restarts"] == 1
        recs[package] = _by_request(path, futs)
        lives[package] = {k: v["span_id"] for k, v in live.items()}
        assert lives[package] == {f.trace_id: f.trace.span_id
                                  for f in futs}
        assert [f.result(timeout=0) for f in futs] == \
            [oracle(model, [1, 2, 3], 6), oracle(model, [4, 5], 5),
             oracle(model, [6, 7, 8, 9], 4, seed=3, temperature=0.8)]
    for r in recs["port"]:
        assert r["events"] == ["engine_restart", "resume"]
        assert r["retained"] in ("event", "forced")
    for p, j in zip(recs["port"], recs["jax"]):
        # the re-prefill's wasted tokens and the tick detail ride the
        # same schedule in both engines
        assert p == j


def test_spec_fallback_events_match_the_jax_engine(model, tmp_path,
                                                    no_tracing):
    """A stream the n-gram draft cannot predict: the adaptive control
    disables the slot, probes it and disables it again, and each disable
    puts one ``spec_fallback`` event on the request's span, as many in
    both engines; the event does not force the detail's retention."""
    recs = {}
    for package, TR in (("jax", JTR), ("port", TTR)):
        path = str(tmp_path / f"{package}.spec.jsonl")
        TR.start_spans(path, sampling=TR.SpanSampling(**SAMPLING))
        try:
            engine = make_engine(model, package, **BASE, speculative=True,
                                 spec_k=3, spec_probe_period=8,
                                 spec_window=2)
            fut = engine.submit([3, 4, 5, 6], max_new_tokens=30)
            run(engine, [fut])
        finally:
            TR.stop_spans()
        assert fut.result(timeout=0) == oracle(model, [3, 4, 5, 6], 30)
        recs[package] = _by_request(path, [fut])
    assert recs["port"] == recs["jax"]
    (rec,) = recs["port"]
    assert rec["events"] and set(rec["events"]) == {"spec_fallback"}
    assert rec["retained"] is None


def test_jax_reads_the_span_id_from_the_ports_journal(model, tmp_path,
                                                      no_tracing):
    jp = str(tmp_path / "journal.jsonl")
    engine = make_engine(model, "port", **BASE, journal_path=jp)
    fut = engine.submit([1, 2, 3], max_new_tokens=20, trace_id="kill-me")
    for _ in range(6):
        engine.step()
    assert not fut.done()
    for S in (JS, TS):
        desc = S.RequestJournal.read_live(jp)["kill-me"]
        assert desc["span_id"] == fut.trace.span_id
        assert desc["emitted_tokens"] == fut.tokens_so_far()
    fut.cancel()
    run(engine, [fut])
    assert JS.RequestJournal.read_live(jp) == {}


# -- the server ---------------------------------------------------------------


@pytest.fixture()
def server(model, tmp_path, no_tracing):
    rec = TTR.start_spans(str(tmp_path / "spans" / "server.jsonl"),
                          proc="server")
    engine = make_engine(model, "port", **BASE)
    engine.warmup((4,))
    srv = TS.ServingServer(engine, port=0).start()
    yield rec, "http://%s:%d/generate" % srv.address
    srv.stop(drain_timeout=5.0)
    TTR.stop_spans()


def _post_hdrs(url, payload, headers):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **headers},
        method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _start_for(rec, tid):
    return [l for l in _lines(rec.path) if l["k"] == "s"
            and l["trace"] == tid]


def _fin_for(rec, span_id, timeout=5.0):
    """The span's finish record, polled: the reply goes out when the
    future resolves, just before the recorder writes the finish."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        fins = [l for l in _lines(rec.path)
                if l["k"] == "f" and l["id"] == span_id]
        if fins:
            return fins[0]
        time.sleep(0.02)
    raise AssertionError(f"no finish record for span {span_id}")


class TestIngressHeaders:
    def test_valid_parent_with_valid_trace_propagates(self, server):
        rec, url = server
        code, body = _post_hdrs(
            url, {"tokens": [1, 2], "max_new_tokens": 2},
            {"X-Trace-Id": "prop-1", "X-Parent-Span": "a" * 16,
             "X-Trace-Sampled": "1"})
        assert code == 200 and body["trace_id"] == "prop-1"
        start = _start_for(rec, "prop-1")[0]
        assert start["parent"] == "a" * 16
        assert start["id"] == body["breakdown"]["span_id"]
        assert _fin_for(rec, start["id"])["a"]["retained"] == "forced"

    def test_spoofed_parent_on_fresh_trace_is_dropped(self, server):
        rec, url = server
        code, body = _post_hdrs(url, {"tokens": [1, 2],
                                      "max_new_tokens": 2},
                                {"X-Parent-Span": "b" * 16})
        assert code == 200
        assert "parent" not in _start_for(rec, body["trace_id"])[0]

    @pytest.mark.parametrize("bad", ["has spaces", "x" * 65, "<script>",
                                     ""])
    def test_malformed_or_oversized_parent_dropped(self, server, bad):
        rec, url = server
        code, body = _post_hdrs(
            url, {"tokens": [1, 2], "max_new_tokens": 2},
            {"X-Trace-Id": "prop-bad-" + str(len(bad)),
             "X-Parent-Span": bad})
        assert code == 200
        assert "parent" not in _start_for(rec, body["trace_id"])[0]

    def test_sampled_header_needs_valid_trace_id(self, server):
        rec, url = server
        code, body = _post_hdrs(url, {"tokens": [1, 2],
                                      "max_new_tokens": 2},
                                {"X-Trace-Sampled": "1"})
        assert code == 200
        start = _start_for(rec, body["trace_id"])[0]
        assert "retained" not in _fin_for(rec, start["id"])["a"]


def _families(text):
    return set(parse_prometheus_text(text))


def test_metrics_families_are_the_jax_servers(model, no_tracing):
    """``GET /metrics`` parses strictly; its ``serving_*`` families are
    the JAX engine's for the same config less :data:`NOT_PORTED`, beside
    the default registry's; the achieved-FLOP/s gauge is live after a
    request with ``model_flops_per_token`` set, as the scrape
    refreshes it."""
    jeng = make_engine(model, "jax", **BASE, model_flops_per_token=1e6)
    jax_fams = _families(jeng.metrics.registry.to_prometheus())
    assert NOT_PORTED <= jax_fams
    engine = make_engine(model, "port", **BASE, model_flops_per_token=1e6)
    engine.warmup((4,))
    with TS.ServingServer(engine, port=0) as srv:
        base = "http://%s:%d" % srv.address
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            assert r.headers["Content-Type"].startswith(
                "text/plain; version=0.0.4")
        code, body = http_post_json(base + "/generate",
                                    {"tokens": [3, 4], "max_new_tokens": 6})
        assert code == 200 and body["breakdown"]["tokens"] == 6
        time.sleep(0.01)
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
    fams = parse_prometheus_text(text)
    port_serving = _families(engine.metrics.registry.to_prometheus())
    assert port_serving == jax_fams - NOT_PORTED
    assert port_serving <= set(fams)
    assert _families(default_registry().to_prometheus()) <= set(fams)
    assert fams["serving_model_flops_per_token"]["samples"][0][2] == 1e6
    assert fams["serving_achieved_flops_per_sec"]["samples"][0][2] > 0
    st = engine.stats()
    assert st["model_flops_per_token"] == 1e6
    assert st["achieved_flops_per_sec"] > 0


def test_unconfigured_flops_stay_null():
    snap = TS.ServingMetrics().snapshot()
    assert snap["model_flops_per_token"] is None
    assert snap["achieved_flops_per_sec"] is None
    assert snap["streamed_ttfb_seconds"]["count"] == 0


def test_streamed_ttfb_observed_once_a_stream(model, no_tracing):
    engine = make_engine(model, "port", **BASE)
    with TS.ServingServer(engine, port=0) as srv:
        c = http.client.HTTPConnection(*srv.address, timeout=30)
        c.request("POST", "/generate", json.dumps(
            {"tokens": [1, 2], "max_new_tokens": 5, "stream": True}),
            {"Content-Type": "application/json"})
        events = sse.read_stream(c.getresponse())
        c.close()
    assert events[-1][0] == "done"
    assert events[-1][1]["breakdown"]["tokens"] == 5
    assert engine.stats()["streamed_ttfb_seconds"]["count"] == 1


# -- overhead (the JAX package's tests/test_obs.py bounds) --------------------


def _steady(model):
    engine = make_engine(model, "port", **{**BASE, "n_slots": 2})
    fut = engine.submit([2, 3, 4], max_new_tokens=30)
    for _ in range(6):  # admission and the pipeline's fill
        engine.step()
    assert not fut.done()
    return engine, fut


def test_disabled_tracing_adds_no_host_syncs(model, no_tracing):
    engine, fut = _steady(model)
    syncs0 = engine.metrics.host_syncs.value
    ticks0 = engine.metrics.decode_ticks.value
    for _ in range(10):
        engine.step()
    assert (engine.metrics.host_syncs.value - syncs0
            <= engine.metrics.decode_ticks.value - ticks0)
    assert fut.trace.ticks == []  # no recorder: nothing buffered
    run(engine, [fut])


def test_enabled_tick_emissions_bounded(model, no_tracing):
    """A steady tick makes exactly three tracer calls (its phases): no
    per-token, per-slot or per-future emission on the hot path."""
    calls = {"tick_phase": 0, "other": 0}

    class StubTracer:
        def tick_phase(self, *a, **k):
            calls["tick_phase"] += 1

        def __getattr__(self, name):
            def record(*a, **k):
                calls["other"] += 1
            return record

    engine, fut = _steady(model)
    syncs0 = engine.metrics.host_syncs.value
    prev = TTR.activate(StubTracer())
    try:
        for _ in range(10):
            engine.step()
    finally:
        TTR.activate(prev)
    assert not fut.done()
    assert calls == {"tick_phase": 30, "other": 0}
    assert engine.metrics.host_syncs.value - syncs0 == 10
    run(engine, [fut])


def test_enabled_per_tick_work_bounded(tmp_path, no_tracing):
    """The tracer work of one steady tick (three buffered tick phases
    and the amortized batch flush through the live writer) stays under
    50 us at the p25 (the JAX test's bound)."""
    tracer = TTR.start(str(tmp_path / "perf_trace.json"))
    try:
        n, samples = 400, []
        for _ in range(30):
            t0 = time.perf_counter()
            for _ in range(n):
                tracer.tick_phase("tick_dispatch", 1.0, 1e-4)
                tracer.tick_phase("tick_device_wait", 1.0, 1e-3)
                tracer.tick_phase("tick_host", 1.0, 1e-4)
            samples.append((time.perf_counter() - t0) / n)
        per_tick = float(np.percentile(samples, 25))
        assert per_tick <= 50e-6, f"{per_tick * 1e6:.1f}us per tick"
    finally:
        TTR.stop()


def test_disabled_per_tick_work_bounded(no_tracing):
    """With no tracer the tick's tracing cost is two global reads:
    under 2 us a tick at the p25 (the JAX test's bound)."""
    n, samples = 2000, []
    for _ in range(30):
        t0 = time.perf_counter()
        for _ in range(n):
            if TTR.get() is not None:
                raise AssertionError
            if TTR.get() is not None:
                raise AssertionError
        samples.append((time.perf_counter() - t0) / n)
    assert float(np.percentile(samples, 25)) <= 2e-6


def test_tracer_timeline_and_jsonl(model, tmp_path, no_tracing):
    """With a tracer on, one request lands as a slot-row span with its
    queue/prefill/decode phases, tick phases on the tick row, and one
    JSONL line carrying the breakdown the future returns."""
    tl, jl = tmp_path / "trace.json", tmp_path / "events.jsonl"
    TTR.start(str(tl), jsonl_path=str(jl))
    try:
        engine = make_engine(model, "port", **BASE)
        fut = engine.submit([1, 2, 3], max_new_tokens=5, trace_id="tl-1")
        run(engine, [fut])
    finally:
        TTR.stop()
    events = json.loads(tl.read_text())
    names = [e["name"] for e in events]
    assert "request tl-1" in names
    assert {"queue", "prefill", "decode"} <= set(names)
    assert {"tick_dispatch", "tick_device_wait", "tick_host"} <= set(names)
    rows = _lines(jl)
    assert len(rows) == 1 and rows[0]["event"] == "request"
    b = fut.breakdown()
    assert {k: rows[0][k] for k in b} == b


# -- HOROVOD_TIMELINE over two processes -------------------------------------

_WORKER = textwrap.dedent("""
    import sys, torch
    from horovod_tpu_torch import basics, obs, timeline
    basics.init(device="cpu")
    assert timeline.get() is not None
    for _ in range(2):
        with obs.training_step():
            torch.ones(2).sum().item()
    timeline.get().instant("from_rank_%d" % basics.rank())
    basics.shutdown()
    assert timeline.get() is None
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_horovod_timeline_per_rank_files_merge(tmp_path):
    port = _free_port()
    path = str(tmp_path / "tl.%r.json")
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HOROVOD_TIMELINE=path, PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    files = [tmp_path / f"tl.{r}.json" for r in range(2)]
    for r, f in enumerate(files):
        events = json.loads(f.read_text())
        assert [e["ph"] for e in events if e["name"] == "train_step"] == \
            ["B", "E"] * 2
        assert any(e["name"] == f"from_rank_{r}" for e in events)
    out = tmp_path / "merged.json"
    assert TMERGE.main([str(out)] + [str(f) for f in files]) == 0
    merged = json.loads(out.read_text())
    meta = {e["pid"]: e["args"]["name"] for e in merged
            if e.get("ph") == "M" and e["name"] == "process_name"}
    by_rank = {e["name"]: meta[e["pid"]] for e in merged
               if e["name"].startswith("from_rank_")}
    assert by_rank == {"from_rank_0": "rank 0", "from_rank_1": "rank 1"}
