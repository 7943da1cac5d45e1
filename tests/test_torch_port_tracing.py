"""The port's observability modules against the JAX package's, on the
CPU.

* The copies (``obs/tracing.py``, ``trace_store.py``, ``trace.py``,
  ``merge.py``, ``aggregate.py``, ``fleet.py``) are the JAX package's
  code for code, and ``timeline.py`` is too, less three named parts.
* The pieces, each run through both packages on the same inputs: head
  sampling, the breakdown, a span recorder's records, a span stream read
  back into trees, autopsies, ASCII trees and Perfetto events, the
  timeline merge (also of a ``torch.profiler`` Chrome trace that
  ``Timeline.profile`` wrote), the fleet aggregate and monitor (their
  Prometheus text, ``/fleet`` over HTTP), and the two CLIs, which load
  no JAX."""

import ast
import json
import os
import re
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from horovod_tpu import timeline as JTL
from horovod_tpu.obs import aggregate as JAGG
from horovod_tpu.obs import fleet as JFLEET
from horovod_tpu.obs import merge as JMERGE
from horovod_tpu.obs import registry as JR
from horovod_tpu.obs import trace_store as JSTORE
from horovod_tpu.obs import tracing as JTR
from horovod_tpu_torch import timeline as TTL
from horovod_tpu_torch.obs import aggregate as TAGG
from horovod_tpu_torch.obs import fleet as TFLEET
from horovod_tpu_torch.obs import merge as TMERGE
from horovod_tpu_torch.obs import registry as TR_
from horovod_tpu_torch.obs import trace_store as TSTORE
from horovod_tpu_torch.obs import tracing as TTR

from conftest import parse_prometheus_text

ROOT = Path(__file__).resolve().parents[1]

COPIES = ["obs/tracing.py", "obs/trace_store.py", "obs/trace.py",
          "obs/merge.py", "obs/aggregate.py", "obs/fleet.py"]


def _tree(pkg: str, rel: str, rename: bool) -> ast.Module:
    """The module's syntax tree without its docstring; ``rename`` turns
    every ``horovod_tpu`` module name of the JAX source into the port's
    (its imports, the CLIs' ``prog`` lines and the docstrings' cross
    references name the package they live in)."""
    text = (ROOT / pkg / rel).read_text()
    if rename:
        text = re.sub(r"\bhorovod_tpu\b", "horovod_tpu_torch", text)
    tree = ast.parse(text)
    tree.body = tree.body[1:]
    return tree


@pytest.mark.parametrize("rel", COPIES)
def test_copies_stay_verbatim(rel):
    """The port's module is the JAX package's, code for code, once the
    JAX source names the port's package."""
    assert ast.dump(_tree("horovod_tpu_torch", rel, False)) == \
        ast.dump(_tree("horovod_tpu", rel, True))


def test_timeline_copy_stays_verbatim_but_three_parts():
    """``timeline.py`` is the JAX package's less three parts the device
    forces: the top-level ``import jax``, ``Timeline.profile``
    (``torch.profiler`` for ``jax.profiler.trace``) and the rank read in
    ``expand_rank_path`` (``basics.rank()`` for
    ``basics.process_rank()``)."""
    def strip(tree, jax_side):
        body = []
        for node in tree.body:
            if isinstance(node, ast.Import) and \
                    [a.name for a in node.names] == ["jax"]:
                assert jax_side, "the port's timeline imports jax"
                continue
            if isinstance(node, ast.ClassDef) and node.name == "Timeline":
                n = len(node.body)
                node.body = [f for f in node.body
                             if getattr(f, "name", None) != "profile"]
                assert len(node.body) == n - 1
            body.append(node)
        tree.body = body
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute) and jax_side
                    and node.attr == "process_rank"
                    and getattr(node.value, "id", None) == "basics"):
                node.attr = "rank"
        return ast.dump(tree)

    port = strip(_tree("horovod_tpu_torch", "timeline.py", False), False)
    jax_ = strip(_tree("horovod_tpu", "timeline.py", True), True)
    assert port == jax_


# -- the pieces, both packages on the same inputs ----------------------------


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_head_sampled_same_verdicts(rate):
    """The deterministic head-sampling verdict over 1000 minted ids (the
    port's and the JAX package's mints alike)."""
    ids = [TTR.mint_trace_id() for _ in range(500)] + \
        [JTR.mint_trace_id() for _ in range(500)]
    port = [TTR.head_sampled(i, rate) for i in ids]
    assert port == [JTR.head_sampled(i, rate) for i in ids]
    if rate == 0.0:
        assert not any(port)
    else:
        assert 0 < sum(port) < len(ids)


def _stamped(TR, **stamps):
    tr = TR.RequestTrace("trace-1", parent_span_id="p" * 16)
    tr.span_id = "s" * 16
    for k, v in stamps.items():
        setattr(tr, k, v)
    return tr


@pytest.mark.parametrize("stamps", [
    dict(submitted_at=10.0, admitted_at=10.25, first_token_at=10.5,
         finished_at=12.0, decode_ticks=7, tokens=8, host_sync_lag=0.0031,
         finish="length",
         events=[("resume", 11.0, {"epoch": 1}), ("eviction", 11.5, None)]),
    dict(submitted_at=1.0, finished_at=1.5, error="QueueFullError"),
    dict(submitted_at=2.0, admitted_at=2.5),
], ids=["finished", "rejected", "running"])
def test_breakdown_same_on_scripted_stamps(stamps):
    port = _stamped(TTR, **stamps).breakdown(now=3.0)
    assert port == _stamped(JTR, **stamps).breakdown(now=3.0)
    if port["total_s"] is not None and port["prefill_s"] is not None:
        assert port["queue_wait_s"] + port["prefill_s"] + port["decode_s"] \
            == pytest.approx(port["total_s"], abs=1e-6)


def _span_script(TR, path, sampling):
    """Begin, events, finish and detail through a recorder: one request
    that resumed (retained for its event), one forced, one clean, one
    errored, one long past the tick cap, and a raw span with a typed
    event."""
    rec = TR.SpanRecorder(path, proc="proc-a", role="replica",
                          sampling=sampling)
    traces = []
    for i, kind in enumerate(["resume", "forced", "clean", "error",
                              "long"]):
        tr = TR.RequestTrace(f"trace-{i}",
                             parent_span_id="up" if i == 1 else None)
        tr.span_id = f"span-{i}"
        tr.submitted_at, tr.admitted_at = 100.0 + i, 100.1 + i
        tr.first_token_at, tr.finished_at = 100.2 + i, 100.5 + i
        n = 6 if kind == "long" else 3
        tr.ticks = [(100.2 + i + 0.01 * j, 100.21 + i + 0.01 * j, 1)
                    for j in range(n)]
        tr.decode_ticks = tr.tokens = n
        tr.sampled = kind == "forced"
        rec.request_begin(tr, attrs={"prompt_tokens": 3})
        if kind == "resume":
            rec.request_event(tr, "engine_restart", {"epoch": 0})
            rec.request_event(tr, "resume", {"epoch": 1,
                                             "wasted_tokens": 4})
        if kind == "clean":
            rec.request_event(tr, "spec_fallback", {"slot": 0})
        if kind == "error":
            tr.error = "EngineFailedError"
        else:
            tr.finish = "length"
        rec.request_done(tr)
        traces.append(tr)
    sid = rec.begin("proxy", "trace-0", span_id="up-0", t0=99.0)
    rec.event("trace-0", sid, "retry", {"attempt": 2}, t=99.5)
    rec.finish(sid, t1=106.0, status="ok")
    with pytest.raises(ValueError):
        rec.event("trace-0", sid, "not_a_type")
    rec.close()
    return (rec.n_finished, rec.n_retained, rec.n_dropped), \
        [tr.breakdown() for tr in traces]


def _records(path):
    out = []
    for line in open(path):
        r = json.loads(line)
        for k in ("mono", "wall", "pid"):  # the process and its clocks
            r.pop(k, None)
        if r["k"] == "e" and r["type"] != "retry":
            r.pop("t")  # request_event stamps its own time
        if r["k"] == "f":
            for e in r.get("a", {}).get("events", []):
                e.pop("t_s", None)
        out.append(r)
    return out


def test_span_recorder_writes_the_same_records(tmp_path):
    sampling = dict(latency_threshold_s=10.0, max_tick_spans=4)
    jc, jb = _span_script(JTR, str(tmp_path / "j" / "s.jsonl"),
                          JTR.SpanSampling(**sampling))
    tc, tb = _span_script(TTR, str(tmp_path / "t" / "s.jsonl"),
                          TTR.SpanSampling(**sampling))
    assert tc == jc == (5, 3, 2)
    for b in jb + tb:
        for e in b.get("events", []):
            e.pop("t_s")
    assert tb == jb
    port, jax_ = _records(tmp_path / "t" / "s.jsonl"), \
        _records(tmp_path / "j" / "s.jsonl")
    assert port == jax_
    kinds = [r["k"] for r in port]
    assert kinds.count("s") == 6 and kinds.count("f") == 6
    assert {r["a"].get("retained") for r in port if r["k"] == "f"
            and "retained" in r.get("a", {})} == {"event", "forced",
                                                   "error"}
    # the long request: 4 tick spans kept, 2 shed past the cap
    assert [r["n"] for r in port if r["k"] == "x"
            and r["span"] == "span-4"] == [6]


def test_trace_store_reads_a_jax_stream_as_jax_does(tmp_path):
    """A span stream the JAX package wrote, two processes with one
    killed mid-request (no finish record), read back by both
    packages' stores."""
    d = tmp_path / "spans"
    router = JTR.SpanRecorder(str(d / "router.jsonl"), proc="router",
                              role="router")
    a = JTR.SpanRecorder(str(d / "replica-a.jsonl"), proc="replica-a",
                         role="replica",
                         sampling=JTR.SpanSampling(latency_threshold_s=0.0))
    b = JTR.SpanRecorder(str(d / "replica-b.jsonl"), proc="replica-b",
                         role="replica")
    now = time.monotonic()
    root = router.begin("route", "t-1", span_id="r" * 16, t0=now)
    att1 = router.begin("attempt", "t-1", parent=root, span_id="a1",
                        t0=now + 0.01)
    tr = JTR.RequestTrace("t-1", parent_span_id=att1)
    tr.span_id = "dead-span"
    tr.submitted_at = now + 0.02
    a.request_begin(tr)  # killed: no finish
    a.request_event(tr, "eviction", {"slot": 1})
    router.event("t-1", att1, "failover", {"to": "replica-b"},
                 t=now + 0.2)
    router.finish(att1, t1=now + 0.2, status="error:ConnectionError")
    att2 = router.begin("attempt", "t-1", parent=root, span_id="a2",
                        t0=now + 0.21)
    tr2 = JTR.RequestTrace("t-1", parent_span_id=att2)
    tr2.span_id = "live-span"
    tr2.submitted_at, tr2.admitted_at = now + 0.22, now + 0.23
    tr2.first_token_at, tr2.finished_at = now + 0.25, now + 0.4
    tr2.ticks = [(now + 0.25, now + 0.26, 1)]
    tr2.sampled = True
    tr2.finish = "length"
    b.request_begin(tr2)
    b.request_event(tr2, "resume", {"epoch": 0})
    b.request_done(tr2)
    router.finish(att2, t1=now + 0.41)
    router.finish(root, t1=now + 0.42)
    for r in (router, a, b):
        r.close()

    js = JSTORE.TraceStore.from_dir(str(d))
    ts = TSTORE.TraceStore.from_dir(str(d))
    assert ts.trace_ids() == js.trace_ids() == ["t-1"]

    def shape(nodes):
        return [(n.id, n.name, n.proc, n.unfinished, shape(n.children))
                for n in nodes]

    assert shape(ts.tree("t-1")) == shape(js.tree("t-1"))
    auto = ts.autopsy("t-1")
    assert auto == js.autopsy("t-1")
    assert ts.ascii_tree("t-1") == js.ascii_tree("t-1")
    assert ts.perfetto("t-1") == js.perfetto("t-1")
    assert ts.perfetto() == js.perfetto()
    assert ts.autopsy("nope") is js.autopsy("nope") is None
    assert auto["unfinished_spans"] == ["dead-span"]
    assert auto["failovers"] == 1 and auto["resumed"]


def _write_trace(path, pid, names, truncated=False):
    evs = [{"name": n, "ph": "i", "s": "p", "ts": 100.0 + i, "pid": pid,
            "tid": 0, "args": {}} for i, n in enumerate(names)]
    text = "[\n" + ",\n".join(json.dumps(e) for e in evs)
    if not truncated:
        text += "\n]\n"
    Path(path).write_text(text)


@pytest.mark.parametrize("align", [False, True])
def test_merge_same_output(tmp_path, align):
    """Two timelines (one cut mid-write) merge to the same file."""
    a, b = tmp_path / "tl.rank0.json", tmp_path / "tl.rank1.json"
    _write_trace(a, 4242, ["step_a1", "step_a2"])
    _write_trace(b, 4242, ["step_b1"], truncated=True)
    outs = []
    for M in (JMERGE, TMERGE):
        out = tmp_path / f"merged.{M.__name__}.json"
        argv = [str(out), str(a), str(b)] + (["--align-start"] if align
                                              else [])
        assert M.main(argv) == 0
        outs.append(json.loads(out.read_text()))
    assert outs[0] == outs[1]
    labels = sorted(e["args"]["name"] for e in outs[1]
                    if e.get("name") == "process_name")
    assert labels == ["rank 0", "rank 1"]


def test_profile_trace_merges_beside_the_host_timeline(tmp_path):
    """``Timeline.profile`` on the CPU writes a ``torch.profiler`` Chrome
    trace (a ``{"traceEvents": [...]}`` object) named by rank; both
    packages' ``merge`` read it beside a host timeline, to the same
    events, one pid block each."""
    tl = TTL.Timeline(str(tmp_path / "host.rank0.json"))
    tl.begin("profiled", "host")
    x = torch.randn(64, 64)
    with tl.profile(str(tmp_path / "prof"), device="cpu") as prof:
        (x @ x).sum().item()
    tl.end("profiled")
    tl.close()
    assert prof is not None
    path = Path(tl.profile_path)
    assert path.name == "profile.rank0.json"
    raw = json.loads(path.read_text())
    assert isinstance(raw, dict) and raw["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in raw["traceEvents"])
    outs = []
    for M in (JMERGE, TMERGE):
        out = tmp_path / f"m.{M.__name__}.json"
        assert M.main([str(out), str(tmp_path / "host.rank0.json"),
                       str(path)]) == 0
        outs.append(json.loads(out.read_text()))
    assert outs[0] == outs[1]
    merged = outs[1]
    blocks = {e["pid"] // TMERGE.PID_STRIDE for e in merged}
    assert blocks == {1, 2}
    assert any(e.get("name") == "aten::mm" for e in merged)
    assert any(e.get("name") == "profiled" for e in merged)


def _exports(R):
    regs = {}
    for rank, (c, g, obs) in enumerate(((3, 1.0, (0.05, 0.5)),
                                        (5, 3.0, (2.0,)))):
        r = R.MetricsRegistry()
        r.counter("reqs_total", "requests").inc(c)
        r.gauge("occupancy", "slots").set(g)
        h = r.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
        for v in obs:
            h.observe(v)
        r.counter("errs_total", "errors",
                  labels=("kind",)).labels(kind="oom").inc(rank + 1)
        regs[rank] = r.export()
    return regs


def test_fleet_aggregate_same_text():
    hosts = {0: "host-a", 1: "host-b"}
    j = JAGG.merge_exports(_exports(JR), hosts=hosts)
    t = TAGG.merge_exports(_exports(TR_), hosts=hosts)
    assert t.snapshot() == j.snapshot()
    assert t.to_prometheus() == j.to_prometheus()
    fams = parse_prometheus_text(t.to_prometheus())
    assert fams["reqs_total"]["samples"][0][2] == 8
    bad = TR_.MetricsRegistry()
    bad.histogram("lat_seconds", "latency", buckets=(0.5,)).observe(0.2)
    with pytest.raises(TAGG.BucketMismatchError):
        TAGG.merge_exports({0: _exports(TR_)[0],
                            1: bad.export()}).to_prometheus()


def _drive_monitor(F, R):
    m = F.FleetMonitor(straggler_threshold=2.0, straggler_patience=2)
    m.begin_epoch(3)
    for rank, export in _exports(R).items():
        m.snapshot(rank, f"host-{rank}", export)
    for step in range(1, 5):
        for rank, s in ((0, 0.1), (1, 0.1), (2, 0.9)):
            m.heartbeat(rank, f"host-{rank}",
                        F.parse_heartbeat(json.dumps(
                            {"t": 0.0, "steps": step,
                             "step_s": s}).encode()))
    return m


def _fleet_view(m, F):
    srv = F.FleetServer(m, host="127.0.0.1", port=0).start()
    try:
        base = "http://%s:%d" % srv.address
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        with urllib.request.urlopen(base + "/fleet", timeout=30) as r:
            view = json.loads(r.read())
    finally:
        srv.stop()
    for st in view["ranks"].values():
        st.pop("heartbeat_age_s")
    return text, view


def test_fleet_monitor_same_text_and_view():
    jm, tm = _drive_monitor(JFLEET, JR), _drive_monitor(TFLEET, TR_)
    assert tm.stragglers() == jm.stragglers() == ["2"]
    assert tm.skew == jm.skew
    assert tm.prometheus() == jm.prometheus()
    jt, jv = _fleet_view(jm, JFLEET)
    tt, tv = _fleet_view(tm, TFLEET)
    assert tt == jt and tv == jv
    fams = parse_prometheus_text(tt)
    assert "elastic_step_time_skew" in fams
    assert TFLEET.parse_heartbeat(b"not json") == {}


# -- the CLIs ---------------------------------------------------------------


def _cli(module, *args):
    """Run ``python -m <module> args`` and report whether JAX loaded."""
    code = (f"import runpy, sys; sys.argv = [{module!r}] + {list(args)!r}\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code or 0\n"
            "else:\n"
            "    rc = 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'horovod_tpu'))\n"
            "print('LOADED', bad)\n"
            "sys.exit(rc)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(ROOT), env=env)


def test_trace_cli_runs_without_jax(tmp_path):
    d = tmp_path / "spans"
    rec = TTR.SpanRecorder(str(d / "p.jsonl"), proc="p")
    tr = TTR.RequestTrace("cli-trace")
    tr.submitted_at = tr.admitted_at = 1.0
    tr.first_token_at, tr.finished_at, tr.finish = 1.1, 1.2, "length"
    tr.sampled = True
    rec.request_begin(tr)
    rec.request_done(tr)
    rec.close()
    for args, want in ((["--spans", str(d), "--list"], "cli-trace"),
                       (["--spans", str(d), "cli-trace"], "generate"),
                       (["--spans", str(d), "cli-trace", "--json"],
                        '"trace_id"')):
        out = _cli("horovod_tpu_torch.obs.trace", *args)
        assert out.returncode == 0, out.stderr
        assert want in out.stdout
        assert "LOADED []" in out.stdout, out.stdout
    pf = tmp_path / "pf.json"
    out = _cli("horovod_tpu_torch.obs.trace", "--spans", str(d),
               "cli-trace", "--perfetto", str(pf))
    assert out.returncode == 0 and "LOADED []" in out.stdout
    assert json.loads(pf.read_text())


def test_merge_cli_runs_without_jax(tmp_path):
    a, b = tmp_path / "tl.rank0.json", tmp_path / "tl.rank1.json"
    _write_trace(a, 1, ["x"])
    _write_trace(b, 2, ["y"])
    out_path = tmp_path / "merged.json"
    out = _cli("horovod_tpu_torch.obs.merge", str(out_path), str(a),
               str(b))
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    assert len({e["pid"] for e in json.loads(out_path.read_text())}) == 2


def test_training_step_nests_a_span(tmp_path):
    """``obs.training_step`` nests one ``train_step`` B/E pair a step on
    the active timeline and counts the steps, as the JAX package's."""
    from horovod_tpu_torch import obs

    steps = obs.training_metrics().steps
    n0 = steps.value
    path = tmp_path / "train.json"
    TTL.start_timeline(str(path))
    try:
        for _ in range(3):
            with obs.training_step():
                torch.ones(4).sum().item()
    finally:
        TTL.stop_timeline()
    events = json.loads(path.read_text())
    spans = [(e["ph"], e.get("cat")) for e in events
             if e["name"] == "train_step"]
    assert spans == [("B", "training"), ("E", None)] * 3
    assert steps.value - n0 == 3
    with obs.training_step():  # no timeline: metrics only
        pass
    assert steps.value - n0 == 4


def test_record_compile_counts_and_marks():
    """``record_compile`` counts ``xla_compiles_total{fn=}`` in the
    port's default registry and puts an instant on the active trace."""
    fam = TR_.training_metrics().compiles
    before = fam.labels(fn="unit_fn").value
    TTR.record_compile("unit_fn")
    assert fam.labels(fn="unit_fn").value == before + 1


def test_expand_rank_path(monkeypatch):
    monkeypatch.setenv("HOROVOD_RANK", "3")
    assert TTL.expand_rank_path("t.%r.json") == \
        JTL.expand_rank_path("t.%r.json") == "t.3.json"
    assert TTL.expand_rank_path("plain.json") == "plain.json"
    monkeypatch.delenv("HOROVOD_RANK")
    assert TTL.expand_rank_path("t.%r.json") == "t.0.json"
