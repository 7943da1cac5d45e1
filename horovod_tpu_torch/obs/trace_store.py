"""Assemble cross-process span streams into per-trace span TREES.

A copy of ``horovod_tpu/obs/trace_store.py`` (standard library only, its
imports renamed to the port's): the port keeps its own because
importing anything from ``horovod_tpu`` loads JAX.
``tests/test_torch_port_tracing.py`` holds it to the original,
code for code.

The span layer (:mod:`horovod_tpu_torch.obs.tracing`) has every process —
router, each replica generation, anything else holding a
:class:`~horovod_tpu_torch.obs.tracing.SpanRecorder` — append spans to its
own JSONL stream.  This module is the collector: it reads any number of
those streams, aligns their ``time.monotonic()`` timestamps onto ONE
wall-clock axis via each stream's anchor record, and reassembles the
Dapper-style causal tree per trace id:

    store = TraceStore.from_dir("/tmp/spans")
    store.autopsy("1f0c9a2b...")   # full JSON: every attempt, events,
                                   # carried-token accounting
    store.ascii_tree("1f0c9a2b...")
    store.perfetto("1f0c9a2b...")  # one track per process

The streams it reads are crash evidence, not neat exports: a SIGKILL'd
replica's stream ends mid-request, with a start record and some events
but no finish — the collector keeps that span as ``unfinished`` (end
time unknown, status ``"unfinished"``), which is precisely the signature
a failover autopsy needs ("this attempt never answered").  Torn final
lines are skipped like the request journal does.

Clock alignment: every stream opens with
``{"k": "anchor", "mono": ..., "wall": ...}``; a span's wall time is
``t + (wall - mono)``.  For processes on one host (the replica
deployment model here) that is exact; across hosts it inherits
wall-clock skew, the same caveat as ``obs.merge --align-start``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterable, List, Optional

__all__ = ["SpanNode", "TraceStore"]


class SpanNode:
    """One span, wall-clock aligned, with its children and events."""

    __slots__ = ("id", "parent", "trace", "name", "proc", "role",
                 "t0", "t1", "status", "attrs", "events", "children",
                 "detail")

    def __init__(self, *, id, parent, trace, name, proc, role,
                 t0, t1=None, status=None, attrs=None, detail=False):
        self.id = id
        self.parent = parent
        self.trace = trace
        self.name = name
        self.proc = proc
        self.role = role
        self.t0 = t0
        self.t1 = t1                # None => unfinished (process died?)
        self.status = status        # None until finished
        self.attrs = attrs or {}
        self.events: List[Dict] = []
        self.children: List["SpanNode"] = []
        self.detail = detail        # phase/tick span (tail-sampled tier)

    @property
    def unfinished(self) -> bool:
        return self.t1 is None

    def as_dict(self, origin: float) -> Dict:
        """JSON form with times relative to the trace origin."""
        return {
            "span_id": self.id,
            "parent_span_id": self.parent,
            "name": self.name,
            "proc": self.proc,
            "role": self.role,
            "start_s": round(self.t0 - origin, 6),
            "end_s": round(self.t1 - origin, 6)
            if self.t1 is not None else None,
            "status": self.status
            if self.status is not None else "unfinished",
            "unfinished": self.unfinished,
            "attrs": self.attrs,
            "events": [
                {"type": e["type"], "proc": e["proc"],
                 "t_s": round(e["t"] - origin, 6), "attrs": e["attrs"]}
                for e in self.events],
            "children": [c.as_dict(origin) for c in self.children],
        }


class TraceStore:
    """Parse span JSONL streams and serve per-trace trees.

    ``paths`` may mix files and globs; unreadable or empty inputs are
    skipped (one dead stream must not cost the autopsy — the healthy
    processes' spans still assemble).  Streams are re-read per
    construction: build a fresh store per query, the autopsy path is
    cold by design."""

    def __init__(self, paths: Iterable[str]):
        self.paths: List[str] = []
        for p in paths:
            hits = sorted(glob.glob(p))
            self.paths.extend(hits if hits else [p])
        # trace_id -> span_id -> SpanNode (detail spans get synthetic ids)
        self._spans: Dict[str, Dict[str, SpanNode]] = {}
        # span_id -> node across ALL traces (ids are uuid-unique):
        # finish-record resolution must be O(1), not a scan per record
        self._by_id: Dict[str, SpanNode] = {}
        # trace_id -> events that named no (known) span
        self._loose: Dict[str, List[Dict]] = {}
        self._drops: Dict[str, int] = {}
        self.processes: List[str] = []
        #: streams actually opened and decoded — 0 means the store
        #: found NOTHING (wrong directory, every file unreadable),
        #: which callers must distinguish from "trace id unknown"
        self.n_readable: int = 0
        self._load()

    @classmethod
    def from_dir(cls, span_dir: str) -> "TraceStore":
        """Every ``*.jsonl`` stream under one spans directory — the
        layout ``ReplicaSupervisor(span_dir=...)`` and the router's own
        recorder share."""
        return cls([os.path.join(span_dir, "*.jsonl")])

    # -- parsing -----------------------------------------------------------

    def _load(self) -> None:
        seen_procs: List[str] = []
        synth = 0
        for path in self.paths:
            try:
                with open(path, "r", encoding="utf-8") as f:
                    raw = f.read()
            except (OSError, UnicodeDecodeError, ValueError):
                # One unreadable input (permissions, stray binary file
                # matching the glob) must not cost the healthy streams
                # their autopsy.
                continue
            self.n_readable += 1
            offset = 0.0   # wall = mono + offset; 0 until the anchor
            proc = os.path.basename(path)
            role = "process"
            # Two passes per file: spans first, then events/finishes —
            # a finish record can precede nothing, but events may refer
            # to spans started later in a concurrent writer's stream
            # ordering.  (Within one file starts do come first, but the
            # two-pass shape keeps the parser order-independent.)
            # Every RECORD is individually guarded: a foreign or
            # corrupted line (e.g. "t0": null) is skipped, never a
            # store-wide failure.
            pend: List[Dict] = []
            for line in raw.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn write at a kill instant
                if not isinstance(ev, dict):
                    continue  # foreign JSONL sharing the directory
                k = ev.get("k")
                try:
                    if k == "anchor":
                        offset = float(ev.get("wall", 0.0)) \
                            - float(ev.get("mono", 0.0))
                        proc = ev.get("proc", proc)
                        role = ev.get("role", role)
                        if proc not in seen_procs:
                            seen_procs.append(proc)
                    elif k == "s":
                        tid = ev.get("trace")
                        node = SpanNode(
                            id=ev.get("id"), parent=ev.get("parent"),
                            trace=tid, name=ev.get("name", "?"),
                            proc=ev.get("proc", proc), role=role,
                            t0=float(ev.get("t0", 0.0)) + offset,
                            attrs=ev.get("a"))
                        self._spans.setdefault(tid, {})[node.id] = node
                        self._by_id[node.id] = node
                    elif k == "d":
                        tid = ev.get("trace")
                        synth += 1
                        node = SpanNode(
                            id=f"_d{synth}", parent=ev.get("parent"),
                            trace=tid, name=ev.get("name", "?"),
                            proc=ev.get("proc", proc), role=role,
                            t0=float(ev.get("t0", 0.0)) + offset,
                            t1=float(ev.get("t1", 0.0)) + offset,
                            status="ok", attrs=ev.get("a"), detail=True)
                        self._spans.setdefault(tid, {})[node.id] = node
                    elif k in ("e", "f", "x"):
                        pend.append({**ev, "_offset": offset,
                                     "_proc": proc})
                except (TypeError, ValueError):
                    continue  # one malformed record, not a dead store
            for ev in pend:
                k, offset = ev["k"], ev["_offset"]
                try:
                    if k == "f":
                        node = self._by_id.get(ev.get("id"))
                        if node is not None:
                            node.t1 = float(ev.get("t1", 0.0)) + offset
                            node.status = ev.get("status", "ok")
                            if ev.get("a"):
                                node.attrs.update(ev["a"])
                    elif k == "e":
                        tid = ev.get("trace")
                        rec = {"type": ev.get("type"),
                               "t": float(ev.get("t", 0.0)) + offset,
                               "proc": ev.get("proc", ev["_proc"]),
                               "span": ev.get("span"),
                               "attrs": ev.get("a") or {}}
                        node = self._spans.get(tid, {}).get(
                            ev.get("span"))
                        if node is not None:
                            node.events.append(rec)
                        else:
                            self._loose.setdefault(tid, []).append(rec)
                    elif k == "x":
                        tid = ev.get("trace")
                        self._drops[tid] = self._drops.get(tid, 0) \
                            + int(ev.get("n", 0))
                except (TypeError, ValueError):
                    continue
        self.processes = seen_procs

    # -- assembly ----------------------------------------------------------

    def trace_ids(self) -> List[str]:
        return sorted(t for t in self._spans if t)

    def tree(self, trace_id: str) -> List[SpanNode]:
        """Root spans of ``trace_id`` with children attached (sorted by
        start time).  A span whose parent is unknown — upstream process
        not collected, or the parent id came from a caller outside this
        deployment — becomes a root rather than vanishing."""
        spans = self._spans.get(trace_id, {})
        for node in spans.values():
            node.children = []
        roots: List[SpanNode] = []
        for node in spans.values():
            parent = spans.get(node.parent) if node.parent else None
            if parent is not None and parent is not node:
                parent.children.append(node)
            else:
                roots.append(node)
        for node in spans.values():
            node.children.sort(key=lambda n: n.t0)
            node.events.sort(key=lambda e: e["t"])
        roots.sort(key=lambda n: n.t0)
        return roots

    # -- views -------------------------------------------------------------

    def autopsy(self, trace_id: str) -> Optional[Dict]:
        """The full post-mortem JSON for one trace (what the router
        serves at ``GET /trace/<id>``), or None for an unknown id."""
        roots = self.tree(trace_id)
        loose = self._loose.get(trace_id, [])
        if not roots and not loose:
            return None
        spans = self._spans.get(trace_id, {})
        origin = min(n.t0 for n in spans.values()) if spans \
            else min(e["t"] for e in loose)
        ends = [n.t1 for n in spans.values() if n.t1 is not None]
        events: List[Dict] = list(loose)
        for node in spans.values():
            events.extend(node.events)
        events.sort(key=lambda e: e["t"])
        carried = sum(e["attrs"].get("carried", 0) for e in events
                      if e["type"] == "resume")
        # "Attempts" = the spans a failover postmortem reads first:
        # each replica-side request span (one per engine that touched
        # the request) and each router proxy-attempt span.
        attempts = sorted(
            (n for n in spans.values()
             if not n.detail and (n.role == "replica"
                                  or n.name.startswith("attempt"))),
            key=lambda n: n.t0)
        return {
            "trace_id": trace_id,
            "processes": sorted({n.proc for n in spans.values()}
                                | {e["proc"] for e in loose}),
            "span_count": len(spans),
            "unfinished_spans": sorted(
                n.id for n in spans.values() if n.unfinished),
            "start_wall": round(origin, 6),
            "duration_s": round(max(ends) - origin, 6) if ends else None,
            "events": [
                {"type": e["type"], "proc": e["proc"],
                 "span": e.get("span"),
                 "t_s": round(e["t"] - origin, 6), "attrs": e["attrs"]}
                for e in events],
            "resumed": any(e["type"] == "resume" for e in events),
            "failovers": sum(e["type"] == "failover" for e in events),
            "retries": sum(e["type"] == "retry" for e in events),
            "carried_tokens": carried,
            "detail_spans_dropped": self._drops.get(trace_id, 0),
            "attempts": [
                {"span_id": n.id, "name": n.name, "proc": n.proc,
                 "start_s": round(n.t0 - origin, 6),
                 "end_s": round(n.t1 - origin, 6)
                 if n.t1 is not None else None,
                 "status": n.status
                 if n.status is not None else "unfinished",
                 "unfinished": n.unfinished,
                 "attrs": n.attrs}
                for n in attempts],
            "tree": [r.as_dict(origin) for r in roots],
        }

    def ascii_tree(self, trace_id: str) -> Optional[str]:
        """Render one trace as an indented ASCII tree (the CLI view)."""
        roots = self.tree(trace_id)
        if not roots:
            return None
        spans = self._spans.get(trace_id, {})
        origin = min(n.t0 for n in spans.values())
        lines = [f"trace {trace_id}  "
                 f"({len(spans)} spans, "
                 f"{len({n.proc for n in spans.values()})} process(es))"]

        def fmt(node: SpanNode) -> str:
            if node.t1 is not None:
                tail = (f"{node.t0 - origin:7.3f}s +"
                        f"{node.t1 - node.t0:.3f}s  {node.status}")
            else:
                tail = (f"{node.t0 - origin:7.3f}s +?       "
                        f"UNFINISHED (no finish record — process died?)")
            return f"{node.name} [{node.proc}]  {tail}"

        def walk(node: SpanNode, prefix: str, last: bool) -> None:
            branch = "`- " if last else "|- "
            lines.append(prefix + branch + fmt(node))
            child_prefix = prefix + ("   " if last else "|  ")
            items: List = [("e", e) for e in node.events] \
                + [("n", c) for c in node.children]
            items.sort(key=lambda it: it[1]["t"] if it[0] == "e"
                       else it[1].t0)
            for i, (kind, it) in enumerate(items):
                last_i = i == len(items) - 1
                if kind == "e":
                    b = "`- " if last_i else "|- "
                    attrs = f"  {it['attrs']}" if it["attrs"] else ""
                    lines.append(child_prefix + b
                                 + f"! {it['type']} @"
                                 f"{it['t'] - origin:.3f}s{attrs}")
                else:
                    walk(it, child_prefix, last_i)

        for i, root in enumerate(roots):
            walk(root, "", i == len(roots) - 1)
        drops = self._drops.get(trace_id, 0)
        if drops:
            lines.append(f"({drops} detail span(s) tail-dropped)")
        return "\n".join(lines)

    def perfetto(self, trace_id: Optional[str] = None) -> List[Dict]:
        """Chrome-trace events for one trace (or all), ONE process
        track per recording process — load in https://ui.perfetto.dev.
        Same pid-block idiom as :mod:`horovod_tpu_torch.obs.merge`."""
        ids = [trace_id] if trace_id is not None else self.trace_ids()
        nodes: List[SpanNode] = []
        for tid in ids:
            nodes.extend(self._spans.get(tid, {}).values())
        if not nodes:
            return []
        origin = min(n.t0 for n in nodes)
        procs: Dict[str, int] = {}
        rows: Dict[str, Dict[str, int]] = {}   # proc -> span_id -> tid
        out: List[Dict] = []

        def pid(proc: str) -> int:
            p = procs.get(proc)
            if p is None:
                p = (len(procs) + 1) * 1000
                procs[proc] = p
                rows[proc] = {"_next": 1}
                out.append({"name": "process_name", "ph": "M", "pid": p,
                            "args": {"name": proc}})
                out.append({"name": "process_sort_index", "ph": "M",
                            "pid": p,
                            "args": {"sort_index": len(procs)}})
            return p

        def tid(n: SpanNode) -> int:
            """One thread row per same-process span FAMILY: a span
            whose parent lives in the same process inherits its row
            (children of one request are sequential, so same-row
            slices render as true nesting), while independent roots —
            e.g. concurrent requests on one replica — each get their
            own row instead of false-stacking."""
            r = rows[n.proc]
            parent_tid = r.get(n.parent)
            if parent_tid is None:
                parent_tid = r["_next"]
                r["_next"] += 1
            r[n.id] = parent_tid
            return parent_tid

        # sorted by t0: a same-process parent is always assigned its
        # row before its children look it up
        for n in sorted(nodes, key=lambda n: n.t0):
            p = pid(n.proc)
            tid_row = tid(n)
            end = n.t1 if n.t1 is not None else n.t0
            out.append({
                "name": n.name, "cat": "trace.span", "ph": "X",
                "ts": (n.t0 - origin) * 1e6,
                "dur": max(end - n.t0, 0.0) * 1e6,
                "pid": p, "tid": tid_row,
                "args": {"trace_id": n.trace, "span_id": n.id,
                         "status": n.status or "unfinished",
                         **({"unfinished": True} if n.unfinished
                            else {}), **n.attrs}})
            for e in n.events:
                out.append({
                    "name": e["type"], "cat": "trace.event", "ph": "i",
                    "ts": (e["t"] - origin) * 1e6, "pid": p,
                    "tid": tid_row, "s": "p", "args": e["attrs"]})
        return out
