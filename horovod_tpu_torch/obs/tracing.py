"""Per-request tracing: Dapper-style trace ids through the serving
stack, exported onto the ONE process timeline.

A copy of ``horovod_tpu/obs/tracing.py`` (standard library only, its
imports renamed to the port's): the port keeps its own because
importing anything from ``horovod_tpu`` loads JAX.
``tests/test_torch_port_tracing.py`` holds it to the original,
code for code.

Horovod's flagship debugging tool was its timeline — per-tensor
lifecycle events on one time axis (``native/src/timeline.{h,cc}``).
This module extends that idea to the serving path: every request gets a
**trace id** minted at ``ServingServer`` ingress (or accepted from an
``X-Trace-Id`` header) and carried through ``Scheduler.Request`` →
prefill admission → per-tick decode → retirement, so "where did request
X spend its 900 ms" has an answer:

* a :class:`RequestTrace` rides the request and is stamped at each
  stage boundary; its :meth:`~RequestTrace.breakdown` (queue wait,
  prefill, decode, host-sync lag) is returned in the ``/generate``
  response and appended to a structured JSONL event log;
* the :class:`Tracer` renders request spans, engine tick-phase spans,
  and instant events (XLA compiles, engine restarts, watchdog stalls,
  elastic re-rendezvous) through the existing
  :class:`horovod_tpu_torch.timeline.Timeline` writer thread — so ONE
  Perfetto-loadable file interleaves training-step spans and serving
  request spans on one time axis.

Tracing is **off by default**.  When off, the per-request cost is one
module-global read per hot-path site plus a 16-hex-char id mint at
submit; timestamps for the breakdown are stamped regardless (a handful
of ``time.monotonic()`` calls per request — the breakdown is part of
the ``/generate`` response contract, tracing or not).  When on, each
tick adds three queue puts (bounded, drop-on-full — the timeline's
writer decoupling) and each request retirement one JSONL line.

All timestamps are ``time.monotonic()`` seconds — the same clock the
timeline uses (``monotonic_ns / 1e3`` microseconds), so serving spans
land on the same axis as training spans.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

__all__ = [
    "TRACE_ID_HEADER", "PARENT_SPAN_HEADER", "SAMPLED_HEADER",
    "SPAN_EVENT_TYPES", "RETAIN_EVENT_TYPES", "RequestTrace", "Tracer",
    "SpanSampling", "SpanRecorder",
    "mint_trace_id", "valid_trace_id", "mint_span_id", "valid_span_id",
    "head_sampled", "propagation_from_headers",
    "start", "stop", "get", "activate", "deactivate",
    "start_spans", "stop_spans", "spans", "activate_spans",
    "deactivate_spans",
    "instant", "record_compile",
]

TRACE_ID_HEADER = "X-Trace-Id"

#: Cross-process span parentage (docs/observability.md "Distributed
#: tracing"): the router stamps each proxy attempt's span id here, so
#: the replica's request span nests under the attempt that carried it.
#: Only honored alongside a VALID ``X-Trace-Id`` — a parent span on a
#: freshly minted trace would be a dangling (or spoofed) edge.
PARENT_SPAN_HEADER = "X-Parent-Span"

#: Tail-sampling override: ``X-Trace-Sampled: 1`` forces full-detail
#: span retention for this request.  The router sets it on failover /
#: resume re-dispatches — the downstream share of an interesting trace
#: must not be tail-dropped by a replica that saw nothing unusual.
SAMPLED_HEADER = "X-Trace-Sampled"

#: The typed span-event vocabulary.  Events are the autopsy's edges —
#: why a request hopped processes or lost work — and keeping the set
#: closed keeps the collector and the docs honest.
SPAN_EVENT_TYPES = frozenset({
    "retry",           # router retried the request on another replica
    "failover",        # a replica died at the connection level mid-request
    "eviction",        # paged-cache preemption took this request's slot
    "engine_restart",  # supervised engine restart interrupted the request
    "resume",          # the request continued from journaled state
    "spec_fallback",   # adaptive control disabled speculation on the slot
})

#: The FAILURE-CLASS subset whose presence forces full-detail span
#: retention past tail sampling.  ``spec_fallback`` is deliberately
#: excluded: under a sustained low-acceptance speculative workload the
#: adaptive controller fires it routinely, and "routine at peak load"
#: is exactly what tail sampling must not retain — the event record
#: itself is still written (flushed immediately) and still shows in
#: the breakdown, it just doesn't drag the tick detail with it.
RETAIN_EVENT_TYPES = frozenset({
    "retry", "failover", "eviction", "engine_restart", "resume",
})

_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._\-]{1,64}$")


def mint_trace_id() -> str:
    """A fresh 16-hex-char trace id."""
    return uuid.uuid4().hex[:16]


def valid_trace_id(s) -> bool:
    """True if ``s`` is acceptable as a caller-supplied trace id
    (1-64 chars of ``[A-Za-z0-9._-]``) — anything else is replaced with
    a minted id rather than echoed into logs and trace files."""
    return isinstance(s, str) and bool(_TRACE_ID_RE.match(s))


def mint_span_id() -> str:
    """A fresh 16-hex-char span id."""
    return uuid.uuid4().hex[:16]


def valid_span_id(s) -> bool:
    """Same grammar as trace ids; an invalid ``X-Parent-Span`` is
    DROPPED (the span becomes a root), never echoed into streams."""
    return isinstance(s, str) and bool(_TRACE_ID_RE.match(s))


def propagation_from_headers(headers) -> Tuple[str, Optional[str],
                                               bool]:
    """THE ingress trust rule, single-sourced for every HTTP front
    (replica server and router alike): returns ``(trace_id,
    parent_span, sampled)``.  A valid ``X-Trace-Id`` is accepted,
    anything else replaced with a minted id; and ``X-Parent-Span`` /
    ``X-Trace-Sampled`` are honored ONLY alongside that valid id — a
    parent on a freshly minted trace would be a dangling (or spoofed)
    edge, and a forced-retention flag from an untraced caller is not
    trusted.  ``headers`` is any mapping with ``.get`` (http.server's
    message object qualifies)."""
    hdr = headers.get(TRACE_ID_HEADER)
    valid = valid_trace_id(hdr)
    trace_id = hdr if valid else mint_trace_id()
    parent = headers.get(PARENT_SPAN_HEADER)
    parent = parent if (valid and valid_span_id(parent)) else None
    sampled = valid and headers.get(SAMPLED_HEADER) == "1"
    return trace_id, parent, sampled


def head_sampled(trace_id: str, rate: float) -> bool:
    """Deterministic head sampling: hash the trace id into [0, 1) and
    compare against ``rate``.  Every process holding the same trace id
    reaches the same verdict with no coordination — a head-sampled
    trace is retained END TO END or not at all, never half a tree."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = int(hashlib.md5(trace_id.encode()).hexdigest()[:8], 16)
    return h / float(0xFFFFFFFF) < rate


class RequestTrace:
    """Per-request timing record, stamped as the request moves through
    the stack (all instants ``time.monotonic()`` seconds):

    * ``submitted_at`` — scheduler enqueue (``Scheduler.submit``);
    * ``admitted_at`` — taken from the queue into a prefill batch;
    * ``first_token_at`` — prefill logits fetched (TTFT instant);
    * ``finished_at`` — future resolved (tokens OR typed error);
    * ``decode_ticks`` — decode ticks that emitted a token to this
      request; ``host_sync_lag`` — dispatch→host-fetch latency of the
      latest such tick (with the overlapped pipeline this is the
      one-tick lag made visible);
    * ``finish`` / ``error`` — finish_reason or exception type name.

    Span identity (docs/observability.md "Distributed tracing"):
    ``span_id`` names this request's span in the cross-process tree,
    ``parent_span_id`` is the upstream caller's span (the router's
    proxy-attempt span, via ``X-Parent-Span``), ``sampled`` forces
    full-detail tail-sampling retention, ``events`` collects typed
    span events (resume, eviction, …) and ``ticks`` buffers per-tick
    detail ``(dispatched_at, fetched_at, tokens)`` tuples — written
    out only if the trace survives tail sampling.
    """

    __slots__ = ("trace_id", "submitted_at", "admitted_at",
                 "first_token_at", "finished_at", "slot", "decode_ticks",
                 "tokens", "host_sync_lag", "finish", "error",
                 "span_id", "parent_span_id", "sampled", "events",
                 "ticks", "ticks_overflow")

    #: hard cap on buffered per-tick tuples (memory bound per request)
    MAX_TICKS = 4096

    def __init__(self, trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None):
        self.trace_id = trace_id or mint_trace_id()
        self.submitted_at: Optional[float] = None
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.slot: Optional[int] = None
        self.decode_ticks: int = 0
        self.tokens: int = 0
        self.host_sync_lag: Optional[float] = None
        self.finish: Optional[str] = None
        self.error: Optional[str] = None
        self.span_id: str = mint_span_id()
        self.parent_span_id: Optional[str] = parent_span_id
        self.sampled: bool = False
        self.events: List[Tuple[str, float, Optional[Dict]]] = []
        self.ticks: List[Tuple[float, float, int]] = []
        # ticks seen past the MAX_TICKS buffer cap — never buffered,
        # but COUNTED so drop markers stay honest for long generations
        self.ticks_overflow: int = 0

    def breakdown(self, now: Optional[float] = None) -> Dict:
        """The timing breakdown the ``/generate`` response carries.
        Safe at any stage: missing stamps yield None fields, an
        unfinished request is measured up to ``now``."""
        end = self.finished_at
        if end is None:
            end = now if now is not None else time.monotonic()

        def span(a, b):
            return round(b - a, 6) if a is not None and b is not None \
                else None

        first_wait_end = self.admitted_at if self.admitted_at is not None \
            else end
        events = [
            {"type": k, "t_s": round(t - self.submitted_at, 6)
             if self.submitted_at is not None else None}
            for k, t, _ in self.events]
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            **({"events": events} if events else {}),
            "queue_wait_s": span(self.submitted_at, first_wait_end),
            "prefill_s": span(self.admitted_at, self.first_token_at),
            "decode_s": span(self.first_token_at, end),
            "decode_ticks": self.decode_ticks,
            "tokens": self.tokens,
            "host_sync_lag_s": round(self.host_sync_lag, 6)
            if self.host_sync_lag is not None else None,
            "total_s": span(self.submitted_at, end),
            "finish": self.finish if self.finish is not None else self.error,
        }


class Tracer:
    """Render request spans, tick-phase spans, instants, and a JSONL
    event log through a :class:`horovod_tpu_torch.timeline.Timeline`.

    Thread-safe: resolution can come from the engine thread, the
    watchdog thread, or an HTTP handler — the timeline queue and a JSONL
    lock serialize everything.  Perfetto layout: tick-phase spans on one
    synthetic thread row, request spans on one row per cache slot (so
    concurrent requests never overlap on a track)."""

    TICK_TID = 90           # engine tick-phase row
    QUEUE_TID = 199         # requests rejected/resolved before admission
    SLOT_TID_BASE = 200     # + slot index
    TICK_BATCH = 128        # tick-phase events buffered per queue put

    def __init__(self, timeline, jsonl_path: Optional[str] = None):
        self._tl = timeline
        self._own_timeline = False
        if jsonl_path:
            from horovod_tpu_torch.timeline import expand_rank_path

            jsonl_path = expand_rank_path(jsonl_path)
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._jsonl_lock = threading.Lock()
        self.jsonl_path = jsonl_path
        self._named_tids = set()
        self._tid_lock = threading.Lock()
        # Tick-phase events are the hot emitter (3 per decode tick):
        # buffer them locally and hand the timeline ONE batch per
        # TICK_BATCH events — a per-event queue put wakes the writer
        # thread every time, and those context switches (not the dict
        # builds) are what would show up in steady-state decode tok/s.
        self._tick_buf: list = []
        self._tick_lock = threading.Lock()
        self._name_tid(self.TICK_TID, "serving: engine ticks")
        self._name_tid(self.QUEUE_TID, "serving: queue")

    # -- timeline emission -------------------------------------------------

    def _name_tid(self, tid: int, name: str) -> None:
        with self._tid_lock:
            if tid in self._named_tids:
                return
            self._named_tids.add(tid)
        self._tl.thread_name(tid, name)

    def instant(self, name: str, args: Optional[Dict] = None) -> None:
        self._tl.instant(name, args)

    def tick_phase(self, name: str, start_s: float, dur_s: float) -> None:
        """One engine tick phase (dispatch / device wait / host) as a
        complete span on the tick row.  Hot path: append one TUPLE —
        event dicts are built (and the writer woken) only once per
        TICK_BATCH at flush, so the steady-state decode loop pays
        nanoseconds, not queue wakeups."""
        with self._tick_lock:
            self._tick_buf.append((name, start_s, dur_s))
            if len(self._tick_buf) < self.TICK_BATCH:
                return
            batch, self._tick_buf = self._tick_buf, []
        self._flush_ticks(batch)

    def _flush_ticks(self, batch: list) -> None:
        pid, tid = self._tl.pid, self.TICK_TID
        self._tl.emit_batch([
            {"name": name, "cat": "serving.tick", "ph": "X",
             "ts": start_s * 1e6, "dur": max(dur_s, 0.0) * 1e6,
             "pid": pid, "tid": tid}
            for name, start_s, dur_s in batch])

    def flush(self) -> None:
        """Hand any buffered tick-phase events to the writer."""
        with self._tick_lock:
            batch, self._tick_buf = self._tick_buf, []
        if batch:
            self._flush_ticks(batch)

    def request_done(self, tr: RequestTrace) -> None:
        """A request resolved: emit its span (with nested
        queue/prefill/decode phases) and append the JSONL record."""
        b = tr.breakdown()
        if tr.slot is not None:
            tid = self.SLOT_TID_BASE + tr.slot
            self._name_tid(tid, f"serving: slot {tr.slot}")
        else:
            tid = self.QUEUE_TID
        start, end = tr.submitted_at, tr.finished_at
        if start is not None and end is not None:
            self._tl.complete(f"request {tr.trace_id}", start, end - start,
                              category="serving.request", tid=tid, args=b)
            for phase, a, z in (
                    ("queue", tr.submitted_at, tr.admitted_at),
                    ("prefill", tr.admitted_at, tr.first_token_at),
                    ("decode", tr.first_token_at, tr.finished_at)):
                if a is not None and z is not None and z >= a:
                    self._tl.complete(phase, a, z - a,
                                      category="serving.request", tid=tid)
        self.log_event({"event": "request", "wall_time": time.time(), **b})

    # -- structured log ----------------------------------------------------

    def log_event(self, record: Dict) -> None:
        if self._jsonl is None:
            return
        line = json.dumps(record)
        with self._jsonl_lock:
            self._jsonl.write(line + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        if self._jsonl is not None:
            with self._jsonl_lock:
                self._jsonl.close()
                self._jsonl = None


# -- cross-process spans (docs/observability.md "Distributed tracing") -------


@dataclasses.dataclass(frozen=True)
class SpanSampling:
    """Tail-sampling policy for per-request span DETAIL (phase + tick
    spans).  Attempt-level span records (start/finish/events) are
    always written — the start line must hit the stream before a
    SIGKILL can land for the autopsy to exist at all, and they cost a
    few lines per request; the per-tick detail is what scales with
    tokens and gets sampled.

    A trace keeps its detail when it ERRORS, carries a typed event
    (failover/resume/eviction/…), was FORCED by the ``X-Trace-Sampled``
    header, ran longer than ``latency_threshold_s``, or falls in the
    deterministic ``head_rate`` hash sample (same verdict in every
    process — see :func:`head_sampled`).  Everything else keeps only
    the breakdown already on the finish record."""

    latency_threshold_s: float = 1.0
    head_rate: float = 0.0
    max_tick_spans: int = 512


class SpanRecorder:
    """Append structured spans to a per-process JSONL stream.

    One recorder per process; every line is flushed as written (same
    SIGKILL-durability contract as the request journal), so a killed
    process leaves behind exactly the spans it had started plus every
    typed event up to the kill instant — which is what the collector
    (:mod:`horovod_tpu_torch.obs.trace_store`) renders as an UNFINISHED span
    in the autopsy tree.

    Line vocabulary (``k`` discriminates):

    * ``anchor`` — process identity + a ``(monotonic, wall)`` clock
      pair.  All span timestamps are monotonic seconds; the collector
      uses the anchor to place every process on one wall-clock axis.
    * ``s`` — span start: id, parent, trace, name, t0.  Durable.
    * ``e`` — typed event (:data:`SPAN_EVENT_TYPES`) on a span.  Durable.
    * ``f`` — span finish: t1, status, attrs (the request breakdown
      rides here), and the retention verdict.
    * ``d`` — one DETAIL span (phase or tick), written only for
      retained traces, at finish time.
    * ``x`` — tail-drop marker: how many detail spans were discarded.

    Thread-safe; all writes serialize on one lock.  Failures never
    propagate — spans must not fail serving."""

    def __init__(self, path: str, *, proc: Optional[str] = None,
                 role: str = "process",
                 sampling: Optional[SpanSampling] = None):
        from horovod_tpu_torch.timeline import expand_rank_path

        self.path = expand_rank_path(path)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self.proc = proc or f"pid{os.getpid()}"
        self.role = role
        self.sampling = sampling or SpanSampling()
        self._lock = threading.Lock()
        self._f = open(self.path, "a", encoding="utf-8")
        # Plain ints for benchmark/test introspection; the registry
        # families below are the operational view of the same counts.
        self.n_finished = 0
        self.n_retained = 0
        self.n_dropped = 0
        self._m = _span_metrics()
        self._write({"k": "anchor", "proc": self.proc, "role": self.role,
                     "pid": os.getpid(), "mono": time.monotonic(),
                     "wall": time.time()})

    # -- primitives --------------------------------------------------------

    def _write(self, obj: Dict) -> None:
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.write(json.dumps(obj, separators=(",", ":"))
                              + "\n")
                self._f.flush()
            except (OSError, ValueError):  # pragma: no cover - disk
                pass

    def begin(self, name: str, trace_id: str, *,
              parent: Optional[str] = None,
              span_id: Optional[str] = None,
              t0: Optional[float] = None,
              attrs: Optional[Dict] = None) -> str:
        """Open a span (written immediately); returns its id."""
        sid = span_id or mint_span_id()
        rec = {"k": "s", "id": sid, "trace": trace_id, "name": name,
               "proc": self.proc,
               "t0": t0 if t0 is not None else time.monotonic()}
        if parent:
            rec["parent"] = parent
        if attrs:
            rec["a"] = attrs
        self._write(rec)
        if self._m is not None:
            self._m.spans.inc()
        return sid

    def event(self, trace_id: str, span_id: Optional[str], etype: str,
              attrs: Optional[Dict] = None,
              t: Optional[float] = None) -> None:
        """One typed event (written immediately).  Unknown types raise
        — the vocabulary is closed so autopsies and docs stay in sync."""
        if etype not in SPAN_EVENT_TYPES:
            raise ValueError(f"unknown span event type {etype!r} "
                             f"(know {sorted(SPAN_EVENT_TYPES)})")
        rec = {"k": "e", "trace": trace_id, "type": etype,
               "proc": self.proc,
               "t": t if t is not None else time.monotonic()}
        if span_id:
            rec["span"] = span_id
        if attrs:
            rec["a"] = attrs
        self._write(rec)
        if self._m is not None:
            self._m.events.labels(type=etype).inc()

    def finish(self, span_id: str, *, t1: Optional[float] = None,
               status: str = "ok",
               attrs: Optional[Dict] = None) -> None:
        rec = {"k": "f", "id": span_id, "proc": self.proc,
               "t1": t1 if t1 is not None else time.monotonic(),
               "status": status}
        if attrs:
            rec["a"] = attrs
        self._write(rec)

    # -- request integration ----------------------------------------------

    def request_begin(self, tr: "RequestTrace", name: str = "generate",
                      attrs: Optional[Dict] = None) -> None:
        """Open the request span for ``tr`` (engine submit); the span
        id was minted with the trace, the parent came from
        ``X-Parent-Span``."""
        self.begin(name, tr.trace_id, parent=tr.parent_span_id,
                   span_id=tr.span_id,
                   t0=tr.submitted_at, attrs=attrs)

    def request_event(self, tr: "RequestTrace", etype: str,
                      attrs: Optional[Dict] = None) -> None:
        """Typed event on a request's span: recorded on the trace (for
        the retention verdict and the response breakdown) AND written
        to the stream immediately (durability)."""
        t = time.monotonic()
        tr.events.append((etype, t, attrs))
        self.event(tr.trace_id, tr.span_id, etype, attrs=attrs, t=t)

    def retention(self, tr: "RequestTrace") -> Optional[str]:
        """Why this trace keeps its detail spans, or None (tail-drop)."""
        if tr.error is not None:
            return "error"
        if tr.sampled:
            return "forced"
        if any(k in RETAIN_EVENT_TYPES for k, _, _ in tr.events):
            return "event"
        if (tr.submitted_at is not None and tr.finished_at is not None
                and tr.finished_at - tr.submitted_at
                > self.sampling.latency_threshold_s):
            return "latency"
        if head_sampled(tr.trace_id, self.sampling.head_rate):
            return "head"
        return None

    def request_done(self, tr: "RequestTrace") -> None:
        """Resolution: apply the tail-sampling verdict, write the
        retained detail (phase spans + per-tick spans) or the drop
        marker, then the finish record carrying the breakdown."""
        reason = self.retention(tr)
        # Counters under the lock: resolution can come from the engine
        # thread, the watchdog, or an HTTP handler concurrently.
        with self._lock:
            self.n_finished += 1
            if reason is not None:
                self.n_retained += 1
            else:
                self.n_dropped += 1
        if self._m is not None:
            self._m.requests.inc()
        if reason is not None:
            if self._m is not None:
                self._m.retained.labels(reason=reason).inc()
            for phase, a, z in (
                    ("queue", tr.submitted_at, tr.admitted_at),
                    ("prefill", tr.admitted_at, tr.first_token_at),
                    ("decode", tr.first_token_at, tr.finished_at)):
                if a is not None and z is not None and z >= a:
                    self._write({"k": "d", "trace": tr.trace_id,
                                 "parent": tr.span_id, "proc": self.proc,
                                 "name": phase, "t0": a, "t1": z})
            cap = self.sampling.max_tick_spans
            for t0, t1, n in tr.ticks[:cap]:
                self._write({"k": "d", "trace": tr.trace_id,
                             "parent": tr.span_id, "proc": self.proc,
                             "name": "tick", "t0": t0, "t1": t1,
                             "a": {"tokens": n}})
            # overflow past the buffer cap counts as shed detail too —
            # the drop marker must account for EVERY tick span that
            # did not reach the stream, not just the buffered tail
            shed = max(len(tr.ticks) - cap, 0) + tr.ticks_overflow
            if shed:
                self._write({"k": "x", "trace": tr.trace_id,
                             "span": tr.span_id, "proc": self.proc,
                             "n": shed, "why": "max_tick_spans"})
        else:
            if self._m is not None:
                self._m.dropped.inc()
            if tr.ticks or tr.ticks_overflow:
                self._write({"k": "x", "trace": tr.trace_id,
                             "span": tr.span_id, "proc": self.proc,
                             "n": len(tr.ticks) + tr.ticks_overflow,
                             "why": "tail"})
        b = tr.breakdown()
        b["proc"] = self.proc
        if reason is not None:
            b["retained"] = reason
        self.finish(tr.span_id, t1=tr.finished_at,
                    status=("error:" + tr.error) if tr.error is not None
                    else "ok", attrs=b)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                finally:
                    self._f = None


_span_metrics_ns = None


def _span_metrics():
    """The ``trace_*`` families in the default registry (created once,
    shared by every recorder this process opens)."""
    global _span_metrics_ns
    if _span_metrics_ns is not None:
        return _span_metrics_ns
    try:
        from horovod_tpu_torch.obs.registry import default_registry

        r = default_registry()

        class _NS:
            spans = r.counter(
                "trace_spans_total",
                "span start records written to the span stream",
                exist_ok=True)
            requests = r.counter(
                "trace_requests_total",
                "request spans finalized (retained + tail-dropped)",
                exist_ok=True)
            retained = r.counter(
                "trace_retained_total",
                "request spans that kept full detail, by reason",
                labels=("reason",), exist_ok=True)
            dropped = r.counter(
                "trace_dropped_total",
                "request spans whose detail was tail-dropped",
                exist_ok=True)
            events = r.counter(
                "trace_events_total",
                "typed span events recorded", labels=("type",),
                exist_ok=True)

        _span_metrics_ns = _NS()
    except Exception:  # pragma: no cover - metrics must not break spans
        _span_metrics_ns = None
    return _span_metrics_ns


_spans: Optional[SpanRecorder] = None


def start_spans(path: str, *, proc: Optional[str] = None,
                role: str = "process",
                sampling: Optional[SpanSampling] = None) -> SpanRecorder:
    """Open the process-wide span recorder (``%r`` rank substitution
    accepted in ``path``).  One per process; the engine, server, and
    router all pick it up via :func:`spans`."""
    global _spans
    if _spans is not None:
        raise ValueError("span recording already started")
    rec = SpanRecorder(path, proc=proc, role=role, sampling=sampling)
    _spans = rec
    return rec


def stop_spans() -> None:
    global _spans
    rec, _spans = _spans, None
    if rec is not None:
        rec.close()


def spans() -> Optional[SpanRecorder]:
    """The active span recorder, or None (the hot-path check — one
    global read)."""
    return _spans


def activate_spans(rec: Optional[SpanRecorder]
                   ) -> Optional[SpanRecorder]:
    """Swap the active recorder without touching its file — the A/B
    seam for overhead benchmarks.  Returns the previous one."""
    global _spans
    prev, _spans = _spans, rec
    return prev


def deactivate_spans() -> Optional[SpanRecorder]:
    return activate_spans(None)


# -- module-global tracer lifecycle ------------------------------------------

_tracer: Optional[Tracer] = None


def start(path: Optional[str] = None,
          jsonl_path: Optional[str] = None) -> Tracer:
    """Start request tracing.  Attaches to the already-active process
    timeline when there is one (``HOROVOD_TIMELINE`` /
    ``start_timeline``) so serving and training share one trace file;
    otherwise starts a timeline at ``path``.  Both paths accept the
    ``%r`` rank substitution (docs/timeline.md) so multi-process runs
    don't clobber each other's files."""
    global _tracer
    if _tracer is not None:
        raise ValueError("tracing already started")
    from horovod_tpu_torch import timeline as TL

    tl = TL.get()
    own = False
    if tl is None:
        if not path:
            raise ValueError(
                "no active timeline to attach to; pass a trace path")
        tl = TL.start_timeline(path)
        own = True
    t = Tracer(tl, jsonl_path=jsonl_path)
    t._own_timeline = own
    _tracer = t
    return t


def stop() -> None:
    """Stop tracing; closes the timeline only if :func:`start` opened
    it (an attached training timeline keeps recording)."""
    global _tracer
    t, _tracer = _tracer, None
    if t is None:
        return
    t.close()
    if t._own_timeline:
        from horovod_tpu_torch import timeline as TL

        TL.stop_timeline()


def get() -> Optional[Tracer]:
    """The active tracer, or None (the hot-path check — one global
    read)."""
    return _tracer


def activate(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Swap the active tracer in/out without touching its files —
    the A/B seam for overhead benchmarks and tests.  Returns the
    previously active tracer."""
    global _tracer
    prev, _tracer = _tracer, tracer
    return prev


def deactivate() -> Optional[Tracer]:
    """Detach the active tracer (returned) leaving its files open;
    re-attach with :func:`activate`."""
    return activate(None)


# -- cross-cutting event helpers ---------------------------------------------

def instant(name: str, args: Optional[Dict] = None) -> None:
    """Emit an instant event onto whatever is recording: the active
    tracer's timeline, else the process timeline, else nothing.  Used
    by the engine (restarts, stalls) and the elastic layer
    (re-rendezvous) so lifecycle landmarks land in the trace whichever
    subsystem opened it."""
    tp = _tracer
    if tp is not None:
        tp.instant(name, args)
        return
    from horovod_tpu_torch import timeline as TL

    tl = TL.get()
    if tl is not None:
        tl.instant(name, args)


def record_compile(fn: str) -> None:
    """Count an XLA trace/compile event (``xla_compiles_total{fn=...}``
    in the default registry) and mark it as an instant on the active
    trace.  Call from inside a traced-function body — it runs exactly
    once per (re)compilation."""
    try:
        from horovod_tpu_torch.obs.registry import training_metrics

        training_metrics().compiles.labels(fn=fn).inc()
    except Exception:  # pragma: no cover - registry must never break jit
        pass
    instant("xla_compile", {"fn": fn})
