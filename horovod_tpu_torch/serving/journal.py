"""Decode-state journaling: the durable record that makes in-flight
requests RESUMABLE instead of merely restartable.

A verbatim copy of ``horovod_tpu/serving/journal.py`` (standard
library only): the port keeps its own copy because importing anything
from ``horovod_tpu`` loads JAX.  The file format is the JAX package's
byte for byte: the JAX package's :meth:`RequestJournal.read_live`
parses a journal the port's engine wrote exactly as this copy does.
Tracing is not ported: the port's requests carry only a trace id
(``Request.trace`` is an ``engine.RequestIds``: the caller's
``X-Trace-Id`` or a minted one), so their begin records hold
``"span": null``, and :meth:`read_live` keys them by that trace id as
it does the JAX engine's.  The references to the JAX package's docs and
modules below describe the original.

The paper's fault story (elastic re-rendezvous + ``Join``) keeps the
*job* alive but discards in-flight work; the serving stack inherited
that shape — a supervised engine restart used to fail every in-flight
request, and router failover re-executed a dead replica's requests
from scratch.  At production request lengths that throws away seconds
of paid-for prefill and decode per incident.  The journal closes the
gap: for every live request it records exactly what a resume needs —
the ORIGINAL prompt, the generation parameters, the trace id, the
deadline, and the tokens emitted so far — so a crash costs one tick of
work plus one re-prefill, never the whole request.

Semantics that make resume oracle-exact:

* Tokens are appended ONLY when the engine emits them to the request's
  future (``InferenceEngine._emit``, reached from ``_retire_pending``)
  — the overlapped pipeline's one-tick-lag identity check has already
  run, so the journal never records a token the greedy oracle would
  not have emitted (a dispatched-but-unfetched tick's tokens are the
  "one tick of wasted work" a crash may cost).
* Greedy decode is a pure function of the token sequence, so
  re-prefilling ``prompt + emitted`` and continuing decode yields a
  concatenated output byte-identical to an uninterrupted run.
* An entry ends (and is purged) the instant its future resolves — by
  retirement, typed rejection, cancellation, ``terminate()``, or drain
  force-resolve — so a later restart can never ghost-re-admit work
  nobody is waiting for.

Two tiers of durability:

* **In-memory** (always on with ``EngineConfig.resume``): survives a
  supervised engine restart inside one process — ``_restart``
  re-admits journaled requests with their original
  :class:`~horovod_tpu.serving.engine.GenerationFuture` still live.
* **File-backed** (``EngineConfig.journal_path``): an append-only
  JSONL event log, flushed per event (page cache — the record
  survives SIGKILL of the process, which is the router failover
  story).  :meth:`RequestJournal.read_live` parses a dead replica's
  journal post-mortem, tolerating a torn final line, and returns a
  resume descriptor per live trace id — what
  ``router/server.py`` re-dispatches to a surviving replica.

Journaling is pure host bookkeeping: no device op, no host sync — the
engine's ≤ 1-host-sync-per-tick guarantee is untouched (the perf guard
in ``tests/test_overlap.py`` runs with journaling on by default).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["JournalEntry", "RequestJournal"]


@dataclasses.dataclass
class JournalEntry:
    """Everything a resume needs, for ONE live request.

    ``prompt`` / ``max_new_tokens`` are the ORIGINAL submission (never
    rewritten by a resume — the resume prompt is derived as ``prompt +
    emitted`` each time, so repeated crashes cannot compound).
    ``deadline`` is the in-process absolute ``time.monotonic()``
    instant; ``expires_at`` is the same deadline as absolute wall
    clock, the only form a DIFFERENT process (the router reading a
    dead replica's journal) can interpret."""

    id: int
    prompt: tuple
    max_new_tokens: int
    eos_id: Optional[int] = None
    deadline: Optional[float] = None
    expires_at: Optional[float] = None
    trace_id: Optional[str] = None
    #: the originating request SPAN id (obs/tracing.py): a post-mortem
    #: journal lookup after a SIGKILL hands it to the router, which
    #: stamps it on the resume edge — the resumed attempt links into
    #: the same cross-process trace tree as the dead one.
    span_id: Optional[str] = None
    #: sampling parameters (serving/sampling.py) — a resume must decode
    #: with the ORIGINAL knobs and seed: the PRNG key schedule is
    #: position-based, so ``prompt + emitted`` at the same seed
    #: continues the exact token stream.
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0
    #: SLO priority class (docs/serving.md "Scheduling") — a resume
    #: (restart, preemption, or router failover) re-admits at the
    #: ORIGINAL class: surviving a crash must neither promote nor
    #: demote a request.
    priority: str = "interactive"
    #: ARRIVAL clocks (tuning/replay.py): ``arrival`` is the monotonic
    #: offset in seconds from journal open — the inter-arrival spacing
    #: a replay reproduces — and ``arrival_wall`` the absolute wall
    #: clock of the same instant (the only form another process can
    #: order against its own records).  Optional: journals written
    #: before the arrival field replay in file order at zero offset.
    arrival: Optional[float] = None
    arrival_wall: Optional[float] = None
    #: whether the original caller streamed (``on_token`` / SSE) — a
    #: replay drives streamed requests through the same callback path.
    stream: bool = False
    emitted: List[int] = dataclasses.field(default_factory=list)
    resumes: int = 0

    @property
    def remaining(self) -> int:
        """Decode budget left after the emitted tokens."""
        return self.max_new_tokens - len(self.emitted)

    def descriptor(self) -> Dict:
        """The RESUME DESCRIPTOR — the stable routing-contract shape
        (docs/serving.md "Front tier") a failover re-dispatch consumes:
        the tokens already emitted and the REMAINING wall-clock budget
        (a resumed request inherits what is left of its deadline,
        never a fresh one)."""
        remaining_ms: Optional[float] = None
        if self.expires_at is not None:
            remaining_ms = round((self.expires_at - time.time()) * 1e3, 3)
        return {
            "emitted_tokens": list(self.emitted),
            "deadline_remaining_ms": remaining_ms,
            "span_id": self.span_id,
        }


class RequestJournal:
    """Thread-safe journal of live requests, optionally file-backed.

    ``begin`` at submit, ``append`` per emitted token, ``note_resume``
    per re-admission, ``end`` on resolution (purges the entry).  With
    ``path``, every event is also an append-only JSONL line flushed to
    the kernel immediately — cheap (~µs), and exactly what survives a
    SIGKILL.  The file compacts itself once enough ended entries
    accumulate, so a long-lived replica's journal stays proportional
    to its LIVE request set, not its lifetime traffic."""

    #: ended entries tolerated in the file before a compaction rewrite
    COMPACT_AFTER = 512

    def __init__(self, path: Optional[str] = None):
        self._lock = threading.Lock()
        self._entries: Dict[int, JournalEntry] = {}
        self.path = path
        self._f = None
        self._dead_lines = 0
        # Arrival epoch: begin-lines carry each request's monotonic
        # offset from THIS instant (plus wall clock), so a replay
        # (tuning/replay.py) reconstructs true inter-arrival spacing
        # instead of inferring it from file order.
        self._opened_mono = time.monotonic()
        self._opened_wall = time.time()
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._f = open(path, "a", encoding="utf-8")

    # -- engine-side events -------------------------------------------------

    def begin(self, req) -> JournalEntry:
        """Open an entry for a freshly submitted request.  ``req`` is a
        :class:`~horovod_tpu.serving.scheduler.Request`; its monotonic
        deadline is translated to wall clock here, while both clocks
        still agree."""
        expires = None
        if req.deadline is not None:
            expires = time.time() + (req.deadline - time.monotonic())
        entry = JournalEntry(
            id=req.id, prompt=tuple(req.prompt),
            max_new_tokens=req.max_new_tokens, eos_id=req.eos_id,
            deadline=req.deadline, expires_at=expires,
            trace_id=req.trace.trace_id if req.trace is not None else None,
            span_id=req.trace.span_id if req.trace is not None else None,
            temperature=getattr(req, "temperature", 0.0),
            top_k=getattr(req, "top_k", 0),
            top_p=getattr(req, "top_p", 0.0),
            seed=getattr(req, "seed", 0),
            priority=getattr(req, "priority", "interactive"),
            arrival=round(time.monotonic() - self._opened_mono, 6),
            arrival_wall=time.time(),
            stream=getattr(getattr(req, "future", None),
                           "_on_token", None) is not None)
        with self._lock:
            self._entries[req.id] = entry
            self._write(self._begin_line(entry))
        return entry

    @staticmethod
    def _begin_line(entry: JournalEntry) -> Dict:
        """The ONE shape of a begin record (begin + compaction write
        it; :meth:`read_live` parses it).  Sampling keys are written
        only when non-default, keeping greedy journals byte-compatible
        with pre-sampling readers."""
        line = {"e": "b", "id": entry.id, "trace": entry.trace_id,
                "span": entry.span_id,
                "prompt": list(entry.prompt),
                "max_new": entry.max_new_tokens,
                "eos": entry.eos_id,
                "expires_at": entry.expires_at}
        if entry.temperature > 0.0:
            line["samp"] = [entry.temperature, entry.top_k,
                            entry.top_p, entry.seed]
        if entry.priority != "interactive":
            # Written only when non-default, like "samp": default-class
            # journals stay byte-compatible with pre-priority readers.
            line["pri"] = entry.priority
        if entry.arrival is not None:
            # [monotonic offset from journal open, wall clock] — a
            # NEW key old readers simply ignore (byte-compatible), and
            # the replay reader's arrival-spacing source of truth.
            line["arr"] = [entry.arrival, entry.arrival_wall]
        if entry.stream:
            line["stream"] = 1
        return line

    def append(self, rid: int, tok: int) -> None:
        """Record one EMITTED token (no-op for an already-ended entry —
        a concurrent resolution's purge always wins)."""
        with self._lock:
            entry = self._entries.get(rid)
            if entry is None:
                return
            entry.emitted.append(int(tok))
            self._write({"e": "t", "id": rid, "t": int(tok)})

    def note_resume(self, rid: int) -> None:
        with self._lock:
            entry = self._entries.get(rid)
            if entry is None:
                return
            entry.resumes += 1
            self._write({"e": "r", "id": rid})

    def end(self, rid: int) -> None:
        """Purge an entry — the request resolved (tokens, typed error,
        cancel, terminate, drain).  After this a restart can never
        re-admit it.  Idempotent."""
        with self._lock:
            if self._entries.pop(rid, None) is None:
                return
            self._write({"e": "e", "id": rid})
            self._dead_lines += 1
            if self._f is not None and self._dead_lines >= self.COMPACT_AFTER:
                self._compact_locked()

    # -- introspection ------------------------------------------------------

    def get(self, rid: int) -> Optional[JournalEntry]:
        with self._lock:
            return self._entries.get(rid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def entries(self) -> List[JournalEntry]:
        with self._lock:
            return list(self._entries.values())

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                finally:
                    self._f = None

    # -- file backend -------------------------------------------------------

    def _write(self, obj: Dict) -> None:
        """Caller holds the lock.  ``flush`` pushes the line into the
        kernel page cache — that is the SIGKILL-durability boundary
        this journal defends (host death is the elastic layer's
        problem, not serving's)."""
        if self._f is None:
            return
        try:
            self._f.write(json.dumps(obj, separators=(",", ":")) + "\n")
            self._f.flush()
        except (OSError, ValueError):  # pragma: no cover - disk trouble
            pass  # journaling must never fail serving

    def _compact_locked(self) -> None:
        """Rewrite the file with only LIVE entries (atomic: tmp +
        rename, same recipe as CheckpointManager)."""
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                for entry in self._entries.values():
                    f.write(json.dumps(self._begin_line(entry),
                                       separators=(",", ":")) + "\n")
                    for tok in entry.emitted:
                        f.write(json.dumps({"e": "t", "id": entry.id,
                                            "t": tok},
                                           separators=(",", ":")) + "\n")
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "a", encoding="utf-8")
            self._dead_lines = 0
        except OSError:  # pragma: no cover - disk trouble
            pass

    # -- post-mortem reader (the router failover path) ----------------------

    @staticmethod
    def read_live(path: str) -> Dict[str, Dict]:
        """Parse a journal file — typically a SIGKILL'd replica's —
        and return ``trace_id -> resume descriptor`` for every entry
        that never ended.  Tolerates a torn final line (the process
        died mid-write; every complete line before it is good).  The
        descriptor carries ``emitted_tokens`` and
        ``deadline_remaining_ms`` computed from the wall-clock
        ``expires_at`` AT READ TIME — time spent dead counts against
        the budget, exactly like time spent decoding."""
        live: Dict[int, JournalEntry] = {}
        try:
            with open(path, "r", encoding="utf-8") as f:
                raw = f.read()
        except OSError:
            return {}
        for line in raw.splitlines():
            if not line.strip():
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn write at the kill instant
            e, rid = ev.get("e"), ev.get("id")
            if e == "b":
                samp = ev.get("samp") or [0.0, 0, 0.0, 0]
                arr = ev.get("arr") or [None, None]
                live[rid] = JournalEntry(
                    id=rid, prompt=tuple(ev.get("prompt") or ()),
                    max_new_tokens=int(ev.get("max_new") or 0),
                    eos_id=ev.get("eos"),
                    expires_at=ev.get("expires_at"),
                    trace_id=ev.get("trace"),
                    span_id=ev.get("span"),
                    temperature=float(samp[0]), top_k=int(samp[1]),
                    top_p=float(samp[2]), seed=int(samp[3]),
                    priority=ev.get("pri") or "interactive",
                    arrival=arr[0], arrival_wall=arr[1],
                    stream=bool(ev.get("stream")))
            elif e == "t" and rid in live:
                live[rid].emitted.append(int(ev["t"]))
            elif e == "r" and rid in live:
                live[rid].resumes += 1
            elif e == "e":
                live.pop(rid, None)
        out: Dict[str, Dict] = {}
        for entry in live.values():
            if entry.trace_id is None:
                continue
            out[entry.trace_id] = {
                **entry.descriptor(),
                "prompt": list(entry.prompt),
                "max_new_tokens": entry.max_new_tokens,
                "eos_id": entry.eos_id,
                # Informational for the failover path: the router
                # re-dispatches the ORIGINAL request body (which
                # carries the sampling fields) — the position-based
                # key schedule makes the continuation automatic.
                "temperature": entry.temperature,
                "seed": entry.seed,
                # The router's scratch-rebuild failover path (no
                # original body survived) re-submits at the ORIGINAL
                # class; body-based failovers carry it in the body.
                "priority": entry.priority,
            }
        return out
