"""Chrome-tracing timeline, host-side spans.

A copy of ``horovod_tpu/timeline.py`` with two changes the device
forces: :meth:`Timeline.profile` wraps ``torch.profiler`` (host
operations, and on CUDA the card's kernels, exported as a Chrome trace)
where the JAX package wraps ``jax.profiler.trace``, and
:func:`expand_rank_path` reads the port's ``basics.rank()``.

Reference: ``horovod/common/timeline.{h,cc}`` — per-tensor lifecycle events
written as Chrome trace JSON by a dedicated writer thread fed from a
lock-free queue (SURVEY.md §5.1).  What this module traces is the host
side the device profiler can't see: step boundaries, serving request
and tick spans, lifecycle instants.  Events flow through a plain queue
to a writer thread so the hot path never touches file IO — the same
decoupling as the reference's SPSC queue (``timeline.h:68-70``).  The
writer thread starts when a :class:`Timeline` is made, never lazily, so
an emission inside a CUDA graph capture only enqueues.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import queue
import threading
import time
from typing import Optional


def expand_rank_path(path: str, rank: Optional[int] = None) -> str:
    """Substitute ``%r`` in a trace-file path with this process's rank
    (``HOROVOD_RANK``, else the initialized context's process rank,
    else 0) — so every rank of a multi-process run writes its own file
    instead of all clobbering one (merge them afterwards with
    ``python -m horovod_tpu_torch.obs.merge``)."""
    if "%r" not in path:
        return path
    if rank is None:
        env = os.environ.get("HOROVOD_RANK")
        if env not in (None, ""):
            rank = int(env)
        else:
            from horovod_tpu_torch import basics

            rank = basics.rank() if basics.is_initialized() else 0
    return path.replace("%r", str(rank))


def _dropped_events_counter():
    """Create-or-fetch the process-wide dropped-events counter (shared
    by every Timeline instance; also seeded at init so /metrics exposes
    the family before any timeline exists)."""
    from horovod_tpu_torch.obs.registry import default_registry

    return default_registry().counter(
        "timeline_dropped_events_total",
        "Timeline events dropped on a full writer queue "
        "(the trace file has gaps)", exist_ok=True)


class Timeline:
    def __init__(self, path: str, *, pid: Optional[int] = None,
                 queue_size: int = 1 << 20) -> None:
        path = expand_rank_path(path)
        self.path = path
        self.pid = pid if pid is not None else os.getpid()
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._file = open(path, "w")
        self._file.write("[\n")
        self._first = True
        self._closed = False
        # Dropped-event accounting: _emit sheds load on queue.Full to
        # protect the hot path, but silent loss would make a sparse
        # trace look like a quiet system — count every drop (here and
        # in the process registry) and flush the total as a trailing
        # event on close() so the trace file discloses its own gaps.
        self.dropped_events = 0
        try:
            self._dropped_counter = _dropped_events_counter()
        except Exception:  # pragma: no cover - registry must not gate IO
            self._dropped_counter = None
        self._writer = threading.Thread(target=self._drain, daemon=True)
        self._writer.start()
        atexit.register(self.close)

    # -- event emission (microsecond timestamps, Chrome trace format) -------

    def _emit(self, ev: dict) -> None:
        if self._closed:
            return
        try:
            self._q.put_nowait(ev)
        except queue.Full:  # drop rather than stall the hot path
            self.dropped_events += 1
            if self._dropped_counter is not None:
                self._dropped_counter.inc()

    def emit_batch(self, evs: list) -> None:
        """Enqueue a pre-built group of events as ONE queue item (one
        writer wakeup) — the hot-emitter path (engine tick phases)."""
        if self._closed or not evs:
            return
        try:
            self._q.put_nowait(evs)
        except queue.Full:
            self.dropped_events += len(evs)
            if self._dropped_counter is not None:
                self._dropped_counter.inc(len(evs))

    def begin(self, name: str, category: str = "host", tid: int = 0) -> None:
        self._emit(
            {
                "name": name,
                "cat": category,
                "ph": "B",
                "ts": time.monotonic_ns() / 1e3,
                "pid": self.pid,
                "tid": tid,
            }
        )

    def end(self, name: str, tid: int = 0) -> None:
        self._emit(
            {
                "name": name,
                "ph": "E",
                "ts": time.monotonic_ns() / 1e3,
                "pid": self.pid,
                "tid": tid,
            }
        )

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        self._emit(
            {
                "name": name,
                "ph": "i",
                "s": "p",
                "ts": time.monotonic_ns() / 1e3,
                "pid": self.pid,
                "tid": 0,
                "args": args or {},
            }
        )

    def complete(self, name: str, start_s: float, dur_s: float,
                 category: str = "host", tid: int = 0,
                 args: Optional[dict] = None) -> None:
        """A complete span (Chrome ``X`` event) with an explicit start
        and duration in ``time.monotonic()`` SECONDS — for spans whose
        boundaries were stamped elsewhere (the request tracer resolves
        a span only once the request retires)."""
        ev = {
            "name": name,
            "cat": category,
            "ph": "X",
            "ts": start_s * 1e6,
            "dur": max(dur_s, 0.0) * 1e6,
            "pid": self.pid,
            "tid": tid,
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    def thread_name(self, tid: int, name: str) -> None:
        """Label a synthetic thread row (Chrome ``M``/thread_name
        metadata) — Perfetto shows the label instead of a bare tid."""
        self._emit({
            "name": "thread_name",
            "ph": "M",
            "pid": self.pid,
            "tid": tid,
            "args": {"name": name},
        })

    def mark_cycle(self) -> None:
        """Cycle marker (``HOROVOD_TIMELINE_MARK_CYCLES``,
        ``operations.cc:392-405``) — on TPU, one per train step."""
        self.instant("CYCLE")

    @contextlib.contextmanager
    def activity(self, name: str, category: str = "host", tid: int = 0):
        """Span context manager (the reference's ActivityStart/End pairs,
        ``common.h:31-59``)."""
        self.begin(name, category, tid)
        try:
            yield
        finally:
            self.end(name, tid)

    @contextlib.contextmanager
    def profile(self, logdir: str, device=None):
        """Bracket a region with ``torch.profiler`` — the device-side
        complement of the host timeline.  On a CUDA device it records
        host operations and the card's kernels (kernels replayed from a
        CUDA graph included), on the CPU host operations only.  On exit
        the profile is written as a Chrome trace,
        ``<logdir>/profile.rank<r>.json`` (``self.profile_path``), which
        ``python -m horovod_tpu_torch.obs.merge`` merges beside the host
        timeline; the two clocks are not aligned (``--align-start``
        re-zeroes each file).  Yields the profiler.

        ``device``: the profiled device; None is the initialized
        context's, else CUDA (no CUDA is an error)."""
        import torch
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        from horovod_tpu_torch import basics

        if device is None and basics.is_initialized():
            device = basics.device()
        dev = basics.resolve_device(device)
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with torch_profile(activities=activities) as prof:
            yield prof
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        path = os.path.join(logdir, expand_rank_path("profile.rank%r.json"))
        prof.export_chrome_trace(path)
        self.profile_path = path

    # -- writer thread -------------------------------------------------------

    def _drain(self) -> None:
        while True:
            ev = self._q.get()
            if ev is None:
                return
            # A list is a pre-batched group (Tracer.tick_phase): one
            # queue wakeup carries many events, so a hot emitter costs
            # one writer context switch per BATCH instead of per event.
            for e in (ev if isinstance(ev, list) else (ev,)):
                if not self._first:
                    self._file.write(",\n")
                self._first = False
                json.dump(e, self._file)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._writer.join(timeout=5)
        if self._writer.is_alive():
            # The writer is still draining a huge backlog: the file is
            # NOT ours — appending the trailer or closing would
            # interleave with (and crash) the writer.  Leave the trace
            # truncated (no closing bracket) rather than corrupted; the
            # daemon writer exits at the None sentinel it already has.
            return
        if self.dropped_events:
            # Trailing disclosure: the writer thread is done, so the
            # file (and the _first separator state) is ours to append
            # the drop count as one final instant event.
            if not self._first:
                self._file.write(",\n")
            self._first = False
            json.dump({
                "name": "TIMELINE_DROPPED_EVENTS",
                "ph": "i",
                "s": "g",
                "ts": time.monotonic_ns() / 1e3,
                "pid": self.pid,
                "tid": 0,
                "args": {"dropped_events": self.dropped_events},
            }, self._file)
        self._file.write("\n]\n")
        self._file.close()


_timeline: Optional[Timeline] = None


def start_timeline(path: str, mark_cycles: bool = False) -> Timeline:
    """``hvd.start_timeline`` parity (``common/basics.py``).

    ``mark_cycles`` exports ``HOROVOD_TIMELINE_MARK_CYCLES`` so the
    native control plane (which owns the negotiation cycles) emits a
    cycle tick per background iteration.  The native runtime latches the
    flag at ``hvd.init()`` — when it is already running, the export only
    reaches FUTURE inits, so warn rather than silently no-op (the
    launcher's ``--timeline-mark-cycles`` flag sets the env before
    workers init and is the reliable path)."""
    global _timeline
    if _timeline is not None:
        raise ValueError("timeline already started")
    if mark_cycles:
        os.environ["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
        from horovod_tpu_torch import basics

        if basics.is_initialized():
            import logging

            logging.getLogger("horovod_tpu_torch").warning(
                "start_timeline(mark_cycles=True) after init(): the "
                "native runtime latched the flag at init, so cycle "
                "ticks start at the NEXT init; set "
                "HOROVOD_TIMELINE_MARK_CYCLES=1 (or use horovodrun "
                "--timeline-mark-cycles) before init() instead")
    _timeline = Timeline(path)
    return _timeline


def stop_timeline() -> None:
    global _timeline
    if _timeline is not None:
        _timeline.close()
        _timeline = None
    # don't leak the cycle-marker request into a later, unrelated init
    os.environ.pop("HOROVOD_TIMELINE_MARK_CYCLES", None)


def get() -> Optional[Timeline]:
    from horovod_tpu_torch import basics

    if _timeline is not None:
        return _timeline
    if basics.is_initialized():
        return basics._ctx().timeline
    return None


@contextlib.contextmanager
def trace(name: str, category: str = "host"):
    """Nest a user-named span into the active timeline; no-op (zero
    overhead beyond the lookup) when no timeline is recording — safe to
    leave in production training loops."""
    tl = get()
    if tl is None:
        yield
        return
    with tl.activity(name, category):
        yield
