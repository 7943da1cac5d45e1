"""Request admission and scheduling for the continuous-batching engine.

A verbatim copy of ``horovod_tpu/serving/scheduler.py`` (pure Python):
the port keeps its own copy because importing anything from
``horovod_tpu`` loads JAX.  The references to the JAX package's docs
and modules below describe the original.

The paper's background-controller pattern applied to inference: callers
submit independent requests; a bounded FCFS queue absorbs bursts; the
engine drains it into free cache slots between decode ticks.  Admission
control is explicit and typed — a full queue raises
:class:`QueueFullError` at submit time, a request whose deadline lapsed
while queued is rejected with :class:`DeadlineExceededError` when it
reaches the head, and a request that cannot fit the cache raises
:class:`RequestTooLongError` before it ever queues — so backpressure is
a protocol, not an OOM.

The prefill/decode interleave policy lives here too:
:meth:`Scheduler.take` hands the engine at most ``max_prefills_per_tick``
admissions per decode tick, bounding how long the active batch stalls on
prompt ingestion (time-to-first-token vs decode tok/s — both stay
bounded; see docs/serving.md for tuning).

Admission ORDER is SLO-aware (docs/serving.md "Scheduling"), not plain
FCFS: every request carries a :attr:`Request.priority` class
(``"interactive"`` before ``"batch"``), and within a class requests
are ordered earliest-deadline-first (EDF), submission order breaking
ties — so a latency-budgeted request overtakes best-effort work
without starving it (class order is strict, but a class is only
consulted when every higher class is empty, and preemption — the
engine's side of the contract — only ever claims resources DOWN the
class order).  Requests with no deadline sort after deadlined peers in
their class, in FCFS order.  With every request in one class and no
deadlines this degenerates to exactly the old FCFS behavior.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import threading
import time
from typing import Any, Callable, List, Optional, Sequence


class ServingError(Exception):
    """Base class for typed serving rejections."""


class QueueFullError(ServingError):
    """The bounded request queue is at capacity — retry with backoff."""


class DeadlineExceededError(ServingError):
    """The request's deadline passed before it could be admitted."""


class RequestTooLongError(ServingError):
    """prompt + max_new_tokens exceeds the cache slot capacity."""


class CacheOutOfPagesError(ServingError):
    """The paged KV cache cannot supply the pages a request needs.

    Raised at submit time when ``prompt + max_new_tokens`` could never
    fit the whole page pool; set on an ADMITTED request's future when
    decode-time page growth exhausts the pool and the request is
    preempted to keep older requests progressing.  Requests that merely
    have to WAIT for pages are not rejected — they stay queued (the
    scheduler's ``admit_fn`` back-pressure) until retirements recycle
    pages.  HTTP maps this to 429 (shed load, retry with backoff)."""


class EngineFailedError(ServingError):
    """The engine tick failed (device exception, non-finite logits) and
    every in-flight request was resolved with this error.  The engine
    restarts itself (bounded attempts); callers may retry — unless the
    restart budget is exhausted, in which case new submits raise this
    too and ``/healthz`` reports ``failed``."""


class EngineStalledError(EngineFailedError):
    """The watchdog declared the engine stalled: a tick exceeded its
    wall-clock budget (hung device call).  In-flight AND queued
    requests are resolved with this error — a hung tick may never
    return, so nothing is left waiting on it."""


class DrainingError(ServingError):
    """The server is draining for shutdown — new requests are rejected
    (HTTP 503 ``draining``); admitted requests run to completion."""


_req_ids = itertools.count()

#: Priority classes, best first.  The tuple order IS the scheduling
#: order: class i is served before any request of class i+1, and the
#: engine's preemption policy only ever suspends a victim of a
#: STRICTLY worse class than the winner (docs/serving.md
#: "Scheduling").
PRIORITY_CLASSES = ("interactive", "batch")
_PRIORITY_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}


def priority_rank(priority: str) -> int:
    """Numeric rank of a priority class (lower = served first).
    Raises :class:`ServingError` for an unknown class — the one
    validation every ingress (engine submit, HTTP ``"priority"``
    field, journal resume) shares."""
    try:
        return _PRIORITY_RANK[priority]
    except KeyError:
        raise ServingError(
            f"unknown priority class {priority!r}; expected one of "
            f"{PRIORITY_CLASSES}") from None


@dataclasses.dataclass
class Request:
    """One generation request as the scheduler sees it.

    ``prompt`` is a token-id sequence; ``deadline`` is an ABSOLUTE
    ``time.monotonic()`` instant (None = no deadline); ``future`` is the
    engine's per-request result sink (tokens stream into it, typed
    rejections land on it as exceptions); ``trace`` is the request's
    :class:`~horovod_tpu_torch.serving.engine.RequestIds` — its trace
    id, the key of its journal entry, rides the request through every
    stage, restart and preemption resumes included."""

    prompt: Sequence[int]
    max_new_tokens: int
    future: Any
    eos_id: Optional[int] = None
    deadline: Optional[float] = None
    submitted_at: float = 0.0
    trace: Any = None
    # Per-request speculative-decoding opt-out (None = engine default):
    # False pins the slot to the plain one-token-per-tick greedy path
    # inside the same compiled speculative tick (acceptance forced to
    # zero as data) — output is identical either way, this is a
    # latency-predictability knob, not a correctness one.
    speculative: Optional[bool] = None
    # Per-request sampling (horovod_tpu/serving/sampling.py; validated
    # at submit): temperature=0 is greedy — the default, and what every
    # pre-sampling caller gets.  The engine rides these through the
    # compiled tick as per-slot data columns; a resumed request keeps
    # them verbatim (the PRNG key schedule is position-based, so the
    # re-prefilled continuation lands on the identical key stream).
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0
    # SLO class (PRIORITY_CLASSES; validated at the engine/HTTP
    # ingress): scheduling order is class-then-EDF-then-FCFS, and the
    # engine may preempt a strictly worse class under slot/page
    # pressure.  Survives journaling, restart-resume, and preemption
    # verbatim — a request never changes class mid-life.
    priority: str = "interactive"
    id: int = dataclasses.field(default_factory=lambda: next(_req_ids))

    @property
    def sampled(self) -> bool:
        return self.temperature > 0.0

    @property
    def priority_rank(self) -> int:
        return _PRIORITY_RANK.get(self.priority, len(PRIORITY_CLASSES))


class Scheduler:
    """Bounded priority queue + prefill/decode interleave policy.

    Admission order is (priority class, deadline-EDF, submission id) —
    see the module docstring; with one class and no deadlines this is
    exactly the historical FCFS scheduler.

    Thread-safe: callers submit from any thread; the engine thread
    drains with :meth:`take`.

    ``on_reject`` (constructor) is the ONE metrics hook for shed load:
    it fires for submit-time :class:`QueueFullError` AND for
    :class:`DeadlineExceededError` rejections inside :meth:`take`, so a
    counter wired here sees every rejection path (the engine wires
    ``metrics.rejected``).  ``on_cancel`` fires when a queued request
    is resolved because its future was cancelled before admission.
    """

    def __init__(self, *, max_queue_depth: int = 64,
                 max_prefills_per_tick: int = 2,
                 clock: Callable[[], float] = time.monotonic,
                 on_reject: Optional[
                     Callable[[Request, ServingError], None]] = None,
                 on_cancel: Optional[Callable[[Request], None]] = None,
                 on_expire: Optional[Callable[[Request], None]] = None):
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got "
                             f"{max_queue_depth}")
        if max_prefills_per_tick < 1:
            raise ValueError(f"max_prefills_per_tick must be >= 1, got "
                             f"{max_prefills_per_tick}")
        self.max_queue_depth = max_queue_depth
        self.max_prefills_per_tick = max_prefills_per_tick
        self._clock = clock
        self._on_reject = on_reject
        self._on_cancel = on_cancel
        self._on_expire = on_expire
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()

    @property
    def depth(self) -> int:
        return len(self._q)

    def submit(self, req: Request) -> None:
        """Enqueue FCFS; raises :class:`QueueFullError` at capacity (the
        caller's future is untouched — the submit call itself fails —
        but the constructor's ``on_reject`` IS notified, so shed load
        at submit time counts the same as shed load in :meth:`take`)."""
        req.submitted_at = self._clock()
        if req.trace is not None:
            req.trace.submitted_at = req.submitted_at
        err: Optional[QueueFullError] = None
        with self._lock:
            if len(self._q) >= self.max_queue_depth:
                err = QueueFullError(
                    f"request queue at capacity ({self.max_queue_depth})")
            else:
                self._q.append(req)
        if err is not None:
            if self._on_reject is not None:
                self._on_reject(req, err)
            raise err

    @staticmethod
    def _order_key(req: Request):
        """The ONE scheduling order: priority class, then the
        requeue boost, then EDF within the class (no deadline sorts
        after every deadline), then submission id (FCFS tie-break).
        The boost is what makes :meth:`requeue_front` a guarantee
        rather than a deque position: a suspended victim WITHOUT a
        deadline would otherwise sort behind every deadlined
        same-class arrival forever — a live future nothing could ever
        expire — so requeued requests go ahead of everything
        non-requeued in their class, ids ordering them among
        themselves."""
        return (req.priority_rank,
                0 if getattr(req, "_front", False) else 1,
                req.deadline if req.deadline is not None else float("inf"),
                req.id)

    def _remove(self, reqs: Sequence[Request]) -> None:
        if not reqs:
            return
        gone = set(id(r) for r in reqs)
        with self._lock:
            self._q = collections.deque(
                r for r in self._q if id(r) not in gone)

    def _resolve_dead(self, req: Request,
                      on_reject: Optional[Callable] = None) -> bool:
        """Resolve a queued request that can never be admitted —
        already done (raced a drain), cancelled, or deadline-lapsed.
        Returns True when the request was resolved (and must leave the
        queue)."""
        fut = req.future
        if getattr(fut, "done", lambda: False)():
            # Already resolved elsewhere (e.g. a submit that raced
            # a drain/terminal failure set its exception after
            # enqueuing) — drop it, nothing to admit or notify.
            return True
        if getattr(fut, "cancel_requested", False):
            fut._finish("cancelled")
            if self._on_cancel is not None:
                self._on_cancel(req)
            return True
        if req.deadline is not None and self._clock() > req.deadline:
            admitted_once = (
                getattr(fut, "ttft", None) is not None
                # ttft alone misses a victim preempted MID-INGESTION
                # (admitted, no token yet) — its uninterrupted twin
                # would lapse in-slot and finish "deadline" too, so
                # preemption must not change the observable outcome.
                or getattr(req.trace, "admitted_at", None) is not None)
            if admitted_once:
                # Admitted ONCE already (a preempted/resumed victim
                # waiting to re-admit): the deadline-AFTER-admission
                # contract applies — finish with the partial tokens a
                # previous life emitted (reason "deadline"), never a
                # 504 that discards paid-for output.
                fut._finish("deadline")
                if self._on_expire is not None:
                    self._on_expire(req)
                return True
            err = DeadlineExceededError(
                f"request {req.id} deadline passed while queued "
                f"({self._clock() - req.submitted_at:.3f}s in queue)")
            fut.set_exception(err)
            if self._on_reject is not None:
                self._on_reject(req, err)
            if on_reject is not None:
                on_reject(req, err)
            return True
        return False

    def sweep(self, on_reject: Optional[Callable] = None) -> int:
        """Resolve EVERY dead queued request (deadline lapsed,
        cancelled, already done) wherever it sits in the queue — not
        just the ones :meth:`take` happens to scan past.  The engine
        calls this at each tick boundary, so a doomed request's future
        (and its HTTP 504) resolves within one tick even when a long
        admission stall keeps :meth:`take` from ever reaching it.
        Returns how many requests it resolved."""
        with self._lock:
            snap = list(self._q)  # unsorted: sweep order is irrelevant
        dead = [r for r in snap if self._resolve_dead(r, on_reject)]
        self._remove(dead)
        return len(dead)

    def peek_best_rank(self) -> Optional[int]:
        """The best (lowest) priority rank among queued, still-live
        requests — what the engine's slot-pressure preemption compares
        against the worst active slot.  None when nothing admissible
        waits."""
        now = self._clock()
        best: Optional[int] = None
        with self._lock:
            for req in self._q:
                fut = req.future
                if getattr(fut, "done", lambda: False)():
                    continue
                if getattr(fut, "cancel_requested", False):
                    continue
                if req.deadline is not None and now > req.deadline:
                    continue
                r = req.priority_rank
                if best is None or r < best:
                    best = r
                    if best == 0:
                        break  # nothing outranks the best class
        return best

    def take(self, free_slots: int,
             on_reject: Optional[Callable[[Request, ServingError], None]]
             = None,
             bucket_fn: Optional[Callable[[Request], int]] = None,
             admit_fn: Optional[Callable[[Request], bool]] = None
             ) -> List[Request]:
        """Up to ``min(max_prefills_per_tick, free_slots)`` admissible
        requests in SCHEDULING ORDER (priority class, EDF within
        class, then submission order — :meth:`_order_key`).  Requests
        whose deadline lapsed — or whose future was cancelled — while
        queued are resolved in place (:class:`DeadlineExceededError`
        on the future / finished with reason ``"cancelled"``) without
        consuming a slot or a prefill budget entry, EVEN when the
        budget is zero: dead heads never block the queue.  Both the
        constructor's ``on_reject`` and the per-call one (if given)
        are notified of rejections.

        ``bucket_fn`` makes the batch UNIFORM: after the head of the
        scheduling order is taken, the take stops at the first request
        whose bucket differs from the head's (it stays queued, still
        ahead of everything behind it — the order is never violated,
        only truncated).  The engine uses this so one batched prefill
        serves the whole admission group without padding short prompts
        to a long prompt's bucket, and the compile set stays bounded
        by buckets x K.

        ``admit_fn`` is resource BACK-PRESSURE (the paged KV cache's
        page budget, the chunked-prefill per-tick token budget): a
        request it declines stays queued and the take stops — it is
        neither rejected nor reordered, it just WAITS until the
        resource frees.  Typed rejection is reserved for requests that
        could never run (:class:`CacheOutOfPagesError` at submit
        time)."""
        budget = min(self.max_prefills_per_tick, free_slots)
        if budget <= 0:
            # Nothing can be admitted: return without paying the sort
            # (all slots busy under a deep backlog is the steady state
            # the SLO scheduler targets).  Dead entries are
            # :meth:`sweep`'s job — the engine runs it at every tick
            # boundary, so dead heads still never block the queue.
            return []
        out: List[Request] = []
        removed: List[Request] = []
        bucket: Optional[int] = None
        # The scan only ever needs the first few candidates (budget is
        # small), so a deep queue pays O(n log k) selection, not a
        # full O(n log n) sort; dead entries past the window are
        # sweep's job, same as above.
        with self._lock:
            snap = list(self._q)
        k = max(4 * budget, 16)
        if len(snap) > k:
            cand = heapq.nsmallest(k, snap, key=self._order_key)
        else:
            cand = sorted(snap, key=self._order_key)
        for req in cand:
            if self._resolve_dead(req, on_reject):
                removed.append(req)
                continue
            if budget <= 0:
                break  # everything behind stays queued, order intact
            if bucket_fn is not None:
                b = bucket_fn(req)
                if bucket is None:
                    bucket = b
                elif b != bucket:
                    break  # next tick's head; never reordered past
            if admit_fn is not None and not admit_fn(req):
                break  # waits for the resource, still ahead in order
            out.append(req)
            removed.append(req)
            budget -= 1
        self._remove(removed)
        return out

    def requeue_front(self, reqs: Sequence[Request]) -> None:
        """Put RESUMED (or preempted) requests back into the queue —
        the engine's restart-resume and preemption paths.  Each is
        marked with the requeue BOOST, so :meth:`_order_key` places
        it ahead of everything non-requeued in its class — deadlined
        or not — with original ids ordering requeued peers among
        themselves (the "front" the name promises, now an ordering
        property rather than a deque position).  Deliberately exempt
        from ``max_queue_depth``: these requests were already
        admitted once and their callers are still waiting on live
        futures; bouncing them as :class:`QueueFullError` after
        surviving a crash would make durability depend on queue
        pressure."""
        reqs = list(reqs)
        for r in reqs:
            r._front = True
        with self._lock:
            self._q.extendleft(reversed(reqs))

    def drain_pending(self) -> List[Request]:
        """Atomically remove and return every queued request — the
        terminal-failure / forced-shutdown path, where the caller must
        resolve each future itself so nothing is left hanging."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
        return out
