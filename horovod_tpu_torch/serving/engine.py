"""Continuous-batching inference engine: the paged path with per-slot
sampling, the overlapped decode pipeline and the tick as one CUDA graph,
supervised and durable.

Counterpart of ``horovod_tpu/serving/engine.py`` in its default
configuration (``paged=True``, ``overlap=True``, sampling as data,
``max_restarts=3``, ``tick_timeout=60``, ``resume=True``).  One decode
tick runs over a fixed pool of S slots; new requests land in freed
slots between ticks.

Tick (:meth:`InferenceEngine.step`):

1. **Admit**: take up to K = ``max_prefills_per_tick`` queued requests
   that share one prompt bucket (prompts right-padded to a power of two,
   at least ``min_prefill_bucket``), grant each the pages its prompt
   needs, run ONE batch-K prefill (flash kernel K1 on the card) and land
   its K/V in the granted pages.  The prefill's last-position logits
   give each request its first token: the argmax for an all-greedy
   group, else the sampler at key position ``len(prompt)``.  Admission
   order is the scheduler's: priority class (``interactive`` before
   ``batch``), then earliest deadline, then submission.
2. **Decode**: grant every active slot the page under its next write
   position, then ONE :class:`~horovod_tpu_torch.serving.graph.
   DecodeTick` over all S slots — ``decode_step_paged`` (paged-attention
   kernel K4 on the card) and the per-slot sampled pick — with the page
   table, the active mask and the sampling columns as data.  On CUDA the
   tick is one CUDA graph captured at :meth:`~InferenceEngine.warmup`
   (or at the first tick) and replayed; ``decode_compilations`` counts
   captures and stays 1 across any request mix and any number of
   restarts.

With ``EngineConfig.overlap`` (the default) decoding is a two-stage
pipeline: the token vector lives on the device, tick N+1 is dispatched
before tick N's results are fetched, and tick N's emission and
retirement run while the device computes tick N+1.  A snapshot of which
request each slot held at dispatch keeps the one-tick lag invisible: a
slot's token is emitted only if the slot still holds that request, so no
token follows EOS and a reused slot never receives its previous
tenant's token (:meth:`InferenceEngine._retire_pending`).
``overlap=False`` is the synchronous tick (the A/B baseline); both
modes share ``_retire_pending`` and give identical tokens, equal to the
per-request ``sample_decode`` / ``greedy_decode`` oracle.

Durability, as in the JAX engine:

* **Supervised restarts.**  :meth:`~InferenceEngine.step` never raises.
  A tick that raises — non-finite logits included, from a decode tick
  or from a prefill — restarts the engine: bounded consecutive attempts
  (``max_restarts``) with exponential backoff, the ``degraded`` state
  until a clean tick.  A step that dispatched a tick and fetched none
  is not clean (it proves nothing), so failures that recur at every
  fetch exhaust the budget with the pipeline on as with it off.  The
  restart resets the slot cache and the tick's inputs in place (the
  captured graph reads them by address, so it is never recaptured).
  When the budget is spent, or the reset itself fails (a sticky CUDA
  error poisons every later call), the engine goes terminally
  ``failed`` and every future resolves with
  :class:`~horovod_tpu_torch.serving.scheduler.EngineFailedError`.
* **Journaled resume.**  Every live request is journaled
  (:class:`~horovod_tpu_torch.serving.journal.RequestJournal`: prompt,
  parameters, the tokens emitted so far, under the request's trace id;
  with ``journal_path`` also the JAX package's JSONL file, which a
  front tier reads back by trace id).  A restart re-admits each
  in-flight request by prefilling ``prompt + emitted`` with its
  original future still live, so its tokens equal an uninterrupted
  run's.  A dispatched tick that
  was not yet fetched is dropped, not retired: its tokens were never
  emitted, so the resume computes them again.
* **Preemption instead of failure.**  A page shortage during decode
  growth, or a strictly better-class request waiting on full slots,
  suspends the worst occupant (worst class, youngest within it) through
  the same resume path.  ``resume=False`` fails it with
  :class:`~horovod_tpu_torch.serving.scheduler.CacheOutOfPagesError`.
* **Watchdog.**  :meth:`~InferenceEngine.start` also runs a watchdog
  thread against a per-tick heartbeat: a tick past ``tick_timeout`` is
  declared stalled (``failed``); its requests are held for
  ``stall_grace`` and resume if the tick returns, else resolve with
  :class:`~horovod_tpu_torch.serving.scheduler.EngineStalledError`.
  The watchdog never takes the engine lock and never touches the device
  (a hung device wait cannot be interrupted).

Faults for tests come from
:class:`~horovod_tpu_torch.serving.faults.FaultInjector`
(``EngineConfig.faults``), probed at the JAX engine's sites: ``watchdog``
(top of a step), ``prefill`` (admission), ``decode_tick`` (before a tick
runs; ``nonfinite`` poisons that tick's fetched max logits on the host),
``decode_fetch`` (before a tick's results are fetched) and
``restart_resume`` (in the restart path).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import attention as _attn
from horovod_tpu_torch.ops import paged_attention as _pa
from horovod_tpu_torch.serving.cache import NULL_PAGE, PagedSlotCache
from horovod_tpu_torch.serving.faults import FaultInjector
from horovod_tpu_torch.serving.graph import (
    DecodeTick,
    download,
    upload,
    upload_into,
)
from horovod_tpu_torch.serving.journal import RequestJournal
from horovod_tpu_torch.serving.metrics import ServingMetrics
from horovod_tpu_torch.serving.sampling import (
    SlotSampling,
    seed_key,
    validate,
)
from horovod_tpu_torch.serving.scheduler import (
    CacheOutOfPagesError,
    DrainingError,
    EngineFailedError,
    EngineStalledError,
    QueueFullError,
    Request,
    RequestTooLongError,
    Scheduler,
    ServingError,
    priority_rank,
)

__all__ = ["EngineConfig", "GenerationFuture", "InferenceEngine",
           "RequestIds", "HEALTHY", "DEGRADED", "DRAINING", "FAILED"]

# Lifecycle states (the /healthz vocabulary): healthy and degraded (just
# restarted, not yet proven by a clean tick) serve traffic; draining and
# failed reject new work.
HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
FAILED = "failed"


@dataclasses.dataclass
class RequestIds:
    """A request's trace identity (``Request.trace``): the key of its
    journal entry in :meth:`RequestJournal.read_live`, by which a front
    tier finds a dead replica's live requests.  Tracing is not ported,
    so there is no span and no timing past the submission instant."""

    trace_id: str
    span_id: Optional[str] = None
    submitted_at: Optional[float] = None


class GenerationFuture:
    """Per-request result sink: tokens accumulate as the engine emits
    them; :meth:`result` blocks until retirement or a typed error.

    ``on_token(token_id)`` fires from the engine thread for every
    emitted token, before the future resolves (the server's SSE stream
    hands tokens to its handler thread with it) — keep it cheap."""

    def __init__(self, on_token: Optional[Callable[[int], None]] = None):
        self._tokens: List[int] = []
        self._done = threading.Event()
        self._exc: Optional[BaseException] = None
        self._cancel = False
        self._on_token = on_token
        # Resolution is serialized: the watchdog, a caller-side
        # resolution (a submit racing a drain) and the engine may race,
        # and only one of them may land.
        self._resolve_lock = threading.Lock()
        self.finish_reason: Optional[str] = None
        self.ttft: Optional[float] = None
        self.trace_id: Optional[str] = None  # set at submit
        # Resolution hook (the engine purges the request's journal entry
        # here): fires once, from whichever thread resolves the future,
        # after the resolution is visible.
        self._on_resolve: Optional[Callable[[], None]] = None

    def _add_token(self, tok: int) -> bool:
        """Append one emitted token; False if the future was already
        resolved (the caller must not journal it)."""
        with self._resolve_lock:
            if self._done.is_set():
                return False
            self._tokens.append(tok)
        if self._on_token is not None:
            self._on_token(tok)
        return True

    def tokens_so_far(self) -> List[int]:
        """The tokens emitted so far (a copy), resolved or not."""
        with self._resolve_lock:
            return list(self._tokens)

    def _finish(self, reason: str) -> None:
        with self._resolve_lock:
            if self._done.is_set():
                return
            self.finish_reason = reason
            self._done.set()
        self._fire_resolve()

    def set_exception(self, exc: BaseException) -> None:
        with self._resolve_lock:
            if self._done.is_set():
                return
            self._exc = exc
            self._done.set()
        self._fire_resolve()

    def _fire_resolve(self) -> None:
        # Only the resolving thread gets here: the done-check above is
        # made under the lock.
        cb = self._on_resolve
        if cb is not None:
            try:
                cb()
            except Exception:  # pragma: no cover - cleanup must not fail work
                pass

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Request cancellation; the engine frees the slot (or drops the
        queued request) on its next tick and resolves the future with
        ``finish_reason == "cancelled"``.  False if already resolved."""
        if self._done.is_set():
            return False
        self._cancel = True
        return True

    @property
    def cancel_requested(self) -> bool:
        return self._cancel

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Generated token ids; raises the typed error if the request
        failed, TimeoutError if it is still running at ``timeout``."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation still in progress")
        if self._exc is not None:
            raise self._exc
        return list(self._tokens)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """``n_slots`` (S) is the decode batch; ``max_len`` caps prompt +
    generation per slot (0 = ``cfg.max_seq``); ``max_prefills_per_tick``
    (K) bounds admissions per tick and sizes the batched prefill;
    ``page_size`` / ``n_pages`` shape the page pool (``n_pages=0`` =
    capacity parity: every slot can reach ``max_len``); ``kv_dtype``
    selects page storage (None = the model dtype, "bf16", "f32",
    "int8"); ``max_queue_depth`` bounds the queue;
    ``default_max_new_tokens`` applies when a request names none;
    ``min_prefill_bucket`` floors the power-of-two prompt buckets;
    ``overlap`` runs decoding as the two-stage pipeline (module
    docstring), ``False`` as the synchronous tick.

    Fault tolerance, the JAX engine's knobs and defaults:
    ``max_restarts`` bounds consecutive supervised restarts before the
    engine goes terminally ``failed`` (a clean tick resets the count);
    ``restart_backoff`` / ``restart_backoff_max`` shape the exponential
    backoff between attempts; ``tick_timeout`` is the watchdog's
    per-tick budget in seconds (0 disables the watchdog; it must cover
    the first launch of every kernel shape a tick can meet, so warm the
    resume buckets too); ``watchdog_interval`` is its poll period;
    ``resume`` journals every live request and re-admits in-flight ones
    after a restart or a preemption (``False``: they fail typed);
    ``journal_path`` also writes the journal as an append-only JSONL
    file; ``stall_grace`` is how long past ``tick_timeout`` a stalled
    tick may still return and have its requests resumed (None = one
    more ``tick_timeout``); ``faults`` threads a
    :class:`~horovod_tpu_torch.serving.faults.FaultInjector` through
    the engine's fault sites (tests only)."""

    n_slots: int = 4
    max_len: int = 0
    max_prefills_per_tick: int = 2
    page_size: int = 16
    n_pages: int = 0
    kv_dtype: Optional[str] = None
    max_queue_depth: int = 64
    default_max_new_tokens: int = 64
    min_prefill_bucket: int = 8
    overlap: bool = True
    max_restarts: int = 3
    restart_backoff: float = 0.05
    restart_backoff_max: float = 2.0
    tick_timeout: float = 60.0
    watchdog_interval: float = 0.05
    resume: bool = True
    journal_path: Optional[str] = None
    stall_grace: Optional[float] = None
    faults: Optional[FaultInjector] = None


@dataclasses.dataclass
class _SlotState:
    request: Request
    last_token: int
    n_generated: int


class InferenceEngine:
    """Continuous-batching engine over one model's params + config.

    Drive it synchronously with :meth:`step` or as a background thread
    with :meth:`start` / :meth:`stop` (the HTTP server; this also arms
    the watchdog).  The engine runs on CUDA unless ``device="cpu"`` is
    passed; ``params`` must already live on that device
    (:func:`~horovod_tpu_torch.models.transformer.init_params`,
    :func:`~horovod_tpu_torch.models.convert.params_from_jax`)."""

    def __init__(self, params: Dict, cfg: T.TransformerConfig,
                 engine_cfg: EngineConfig = EngineConfig(), *, device=None):
        self.device = T.resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on "
                f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        ec = engine_cfg
        self.slots = PagedSlotCache(cfg, ec.n_slots, ec.max_len,
                                    page_size=ec.page_size,
                                    n_pages=ec.n_pages, kv_dtype=ec.kv_dtype,
                                    device=self.device)
        self.metrics = ServingMetrics()
        self.scheduler = Scheduler(
            max_queue_depth=ec.max_queue_depth,
            max_prefills_per_tick=ec.max_prefills_per_tick,
            on_reject=lambda req, err: self.metrics.rejected.inc(),
            on_cancel=lambda req: self.metrics.cancelled.inc(),
            # A requeued (preempted or resumed) request whose deadline
            # lapses before re-admission retires with its partial
            # tokens: a completion, not shed load.
            on_expire=lambda req: self.metrics.completed.inc())
        self._states: List[Optional[_SlotState]] = [None] * ec.n_slots
        # Requests taken from the queue but not yet in a slot: a tick
        # failing mid-admission must resolve or resume these too.
        self._taken: List[Request] = []
        self._lock = threading.Lock()  # engine-loop state (step is serial)
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.error: Optional[str] = None

        # Fault-tolerance state.  _hb_lock guards the tick heartbeat,
        # the epoch and the stall flags: the only state the watchdog
        # touches while the engine thread may be hung inside _lock.
        self._hb_lock = threading.Lock()
        self._tick_started: Optional[float] = None
        self._last_tick_done: Optional[float] = None
        self._epoch = 0          # bumped on every restart
        self._stalled = False    # set by the watchdog, cleared on recovery
        self._stall_hard_failed = False  # grace spent: futures resolved
        self._health = HEALTHY
        self._health_lock = threading.Lock()
        self._transitions: List[str] = [HEALTHY]
        self._consec_failures = 0
        # Sticky facts the state alone cannot carry: a stall overwrites
        # DRAINING with FAILED and the restart must restore DRAINING;
        # _terminal marks a failure no restart may undo.
        self._draining = False
        self._terminal = False
        # Requests suspended for resume mid-_recover: in neither the
        # queue nor a slot until the requeue lands.
        self._resuming = 0
        # The journal: every live request's prompt, parameters and
        # emitted tokens — what a restart or a preemption re-admits.
        self.journal: Optional[RequestJournal] = None
        if ec.resume or ec.journal_path:
            self.journal = RequestJournal(ec.journal_path)

        # Host mirror of each slot's device write position (prompt
        # length at admission, +1 per dispatched tick): page grants
        # happen against it before the write that needs them, and it
        # proves capacity, so the tick checks none.
        self._page_pos = np.zeros(ec.n_slots, np.int64)
        # Per-slot sampling columns and the tick (its static inputs: the
        # token vector, the active mask and the page table, each
        # refreshed with copy_ — the table only when table_version
        # moves, the mask only when it changes).
        self._samp = SlotSampling(ec.n_slots, self.device)
        self._tick = DecodeTick(params, cfg, self.slots.cache,
                                self._samp.device(), ec.n_slots,
                                self.slots.max_pages, self.device)
        self._table_uploaded = -1
        self._active_uploaded: Optional[np.ndarray] = None
        # Overlapped pipeline: _pending is the one dispatched tick not
        # yet fetched (its downloads in flight plus the snapshot of the
        # request each slot computed for); _tokens_live says the
        # device token vector holds every active slot's last token.
        self._pending: Optional[Dict] = None
        self._tokens_live = False
        # The last step dispatched a tick and fetched none: not a clean
        # step (see step()).
        self._unchecked_dispatch = False
        self._prefill_calls = 0
        self.metrics.kv_pages_total.set(self.slots.n_pages)
        self.metrics.kv_bytes_per_token.set(self.slots.bytes_per_token)
        self._update_page_gauges()

    # -- lifecycle ---------------------------------------------------------

    @property
    def health(self) -> str:
        """healthy | degraded | draining | failed."""
        return self._health

    @property
    def state_transitions(self) -> List[str]:
        """The state-machine trail (the last 50), oldest first."""
        return list(self._transitions)

    @property
    def terminal(self) -> bool:
        """True once the engine can never serve again (restart budget
        spent, a failed reset, or :meth:`terminate`); a watchdog
        ``failed`` that a restart may still recover from reads False."""
        return self._terminal

    @property
    def heartbeat_age(self) -> Optional[float]:
        """Seconds since the last completed tick (None before the first)."""
        with self._hb_lock:
            t = self._last_tick_done
        return time.monotonic() - t if t is not None else None

    def _set_health(self, state: str, unless: Sequence[str] = ()) -> None:
        """Move to ``state`` and append it to the trail, unless the
        engine already is in it or in one of ``unless``."""
        with self._health_lock:
            if self._health == state or self._health in unless:
                return
            self._health = state
            self._transitions.append(state)
            del self._transitions[:-50]

    def begin_drain(self) -> None:
        """New :meth:`submit` calls raise :class:`DrainingError`; admitted
        and queued requests keep running.  Draining is sticky across a
        stall-recovery restart; a failed engine stays ``failed``."""
        self._draining = True
        self._set_health(DRAINING, unless=(FAILED,))

    # -- submission --------------------------------------------------------

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               deadline: Optional[float] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, seed: Optional[int] = None,
               priority: str = "interactive",
               on_token: Optional[Callable[[int], None]] = None,
               trace_id: Optional[str] = None) -> GenerationFuture:
        """Queue a generation request; returns its future.

        ``temperature`` / ``top_k`` / ``top_p`` / ``seed`` select
        sampling (temperature 0, the default, is greedy); the tokens equal
        ``sample_decode`` of the same prompt with ``rng=seed_key(seed)``,
        across restarts and preemptions too (the key schedule depends on
        the token position only).  ``priority`` is the request's class
        (:data:`~horovod_tpu_torch.serving.scheduler.PRIORITY_CLASSES`):
        classes are admitted strictly in order, and under slot or page
        pressure a request of a strictly worse class may be suspended
        (and later resumed, its tokens unchanged) for a better one.
        ``on_token`` is the future's per-token hook.  ``trace_id`` (the
        server passes the ``X-Trace-Id`` header) keys the request's
        journal entry; a fresh 16-hex-digit id is minted when absent, and
        the future carries it as ``trace_id``.

        Typed rejections, raised here: :class:`ServingError` (empty or
        out-of-vocabulary prompt, ``max_new_tokens < 1``, a bad sampling
        parameter, an unknown class), :class:`RequestTooLongError`,
        :class:`CacheOutOfPagesError` (the request could never fit the
        page pool), :class:`QueueFullError`, :class:`DrainingError` and
        :class:`EngineFailedError`.  A ``deadline`` (absolute
        ``time.monotonic()``) that lapses while queued fails the future
        with ``DeadlineExceededError``; one that lapses after admission
        retires the slot with the partial result (``finish_reason ==
        "deadline"``)."""
        if self._draining:
            raise DrainingError("engine is draining; not accepting work")
        if self._health == FAILED:
            if self._terminal:
                raise EngineFailedError(
                    f"engine has failed permanently ({self.error})")
            raise EngineFailedError(
                "engine is recovering from a stalled tick; retry shortly")
        temperature, top_k, top_p, seed = validate(temperature, top_k,
                                                   top_p, seed)
        priority_rank(priority)  # typed ServingError on an unknown class
        prompt = [int(t) for t in prompt]
        n_new = int(max_new_tokens if max_new_tokens is not None
                    else self.engine_cfg.default_max_new_tokens)
        if not prompt:
            raise ServingError("empty prompt")
        V = self.cfg.vocab_size
        if min(prompt) < 0 or max(prompt) >= V:
            raise ServingError(f"token ids must lie in [0, {V})")
        if n_new < 1:
            raise ServingError(f"max_new_tokens must be >= 1, got {n_new}")
        # The first token comes from prefill logits, so a slot needs room
        # for the prompt plus n_new - 1 decode writes.
        need = len(prompt) + n_new - 1
        if need > self.slots.max_len:
            self.metrics.rejected.inc()
            raise RequestTooLongError(
                f"prompt ({len(prompt)}) + max_new_tokens ({n_new}) "
                f"exceeds slot capacity ({self.slots.max_len})")
        if self.slots.pages_for(need) > self.slots.n_pages:
            self.metrics.rejected.inc()
            raise CacheOutOfPagesError(
                f"prompt ({len(prompt)}) + max_new_tokens ({n_new}) needs "
                f"{self.slots.pages_for(need)} pages; the pool holds "
                f"{self.slots.n_pages}")
        fut = GenerationFuture(on_token=on_token)
        fut.trace_id = trace_id or uuid.uuid4().hex[:16]
        req = Request(prompt=prompt, max_new_tokens=n_new, future=fut,
                      eos_id=eos_id, deadline=deadline,
                      trace=RequestIds(fut.trace_id),
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed, priority=priority)
        if self.journal is not None:
            # Journal before the enqueue, the purge wired first: every
            # resolution funnels through the future, so an entry never
            # outlives its request.
            journal, rid = self.journal, req.id
            fut._on_resolve = lambda: journal.end(rid)
            journal.begin(req)
        try:
            self.scheduler.submit(req)  # QueueFullError counts via on_reject
        except QueueFullError:
            if self.journal is not None:
                self.journal.end(req.id)  # never enqueued: nothing to resume
            raise
        # Re-check after the enqueue: a failure or drain that began
        # between the checks above and the enqueue must not strand it.
        # Only this request is resolved: the queue may hold requests
        # legitimately enqueued after a stall-recovery restart.
        if self._health == FAILED:
            exc = EngineFailedError("engine failed during submit")
            fut.set_exception(exc)
            raise exc
        if self._draining:
            exc = DrainingError("engine began draining during submit")
            fut.set_exception(exc)
            raise exc
        self.metrics.queue_depth.set(self.scheduler.depth)
        return fut

    # -- the tick ----------------------------------------------------------

    def step(self) -> bool:
        """One supervised tick: admit, then one decode over all slots
        (pipelined with ``overlap``).  Returns True if any work was done.

        Never raises: a failure anywhere in the tick restarts the engine
        (:meth:`_recover`) — in-flight requests resume from the journal —
        or, once the restart budget is spent, leaves it terminally
        ``failed`` with every future resolved typed."""
        if self._health == FAILED:
            return False
        with self._hb_lock:
            self._tick_started = time.monotonic()
        try:
            faults = self.engine_cfg.faults
            if faults is not None:
                faults.probe("watchdog")  # a "hang" here stalls the tick
            with self._lock:
                worked = self._reclaim_cancelled()
                worked = self._admit_pending() or worked
                if self.engine_cfg.overlap:
                    worked = self._decode_tick_overlapped() or worked
                else:
                    worked = self._decode_tick() or worked
                self.metrics.queue_depth.set(self.scheduler.depth)
                self.metrics.slot_occupancy.set(self.slots.occupancy)
                self._update_page_gauges()
        except Exception as exc:  # supervised: any tick failure recovers
            with self._hb_lock:
                self._tick_started = None
                stalled = self._stalled
            # A stalled tick that ends by raising is one incident: the
            # watchdog already counted it.
            self._recover(exc, counted=stalled)
            return True
        with self._hb_lock:
            self._tick_started = None
            self._last_tick_done = time.monotonic()
            stalled = self._stalled
        if stalled:
            # The watchdog declared the tick stalled, but it returned:
            # restart through the same supervised path.
            self._recover(EngineStalledError(
                f"tick exceeded the {self.engine_cfg.tick_timeout}s "
                f"watchdog budget"), counted=True)
            return True
        if self._unchecked_dispatch:
            # The step dispatched a tick and fetched none (the overlapped
            # pipeline's first step after an admission): its logits are
            # checked when the next step fetches them, so it proves
            # nothing yet.  Counting it clean would refill the budget
            # between every two failures, and non-finite decode logits
            # would restart the engine forever (the JAX engine does).
            return worked
        # A clean tick: back to healthy, the restart budget refilled.
        if self._consec_failures or self._health == DEGRADED:
            self._consec_failures = 0
            if self._health == DEGRADED:
                self._set_health(HEALTHY)
        return worked

    def _update_page_gauges(self) -> None:
        self.metrics.kv_pages_free.set(self.slots.free_pages)

    def _release(self, slot: int) -> None:
        self._states[slot] = None
        self.slots.free(slot)
        self._samp.clear(slot)  # a zero row: greedy, for the next tenant

    def _reclaim_cancelled(self) -> bool:
        """Free slots whose requests were cancelled caller-side (resolved
        with the tokens so far) or resolved elsewhere."""
        worked = False
        for s, st in enumerate(self._states):
            if st is None:
                continue
            fut = st.request.future
            if not fut.done() and fut.cancel_requested:
                fut._finish("cancelled")
                self.metrics.cancelled.inc()
            if fut.done():
                self._release(s)
                worked = True
        return worked

    def _bucket(self, n: int) -> int:
        b = max(self.engine_cfg.min_prefill_bucket, 1)
        while b < n:
            b *= 2
        return min(b, self.slots.max_len)

    def _n_prompt_pages(self, req: Request) -> int:
        return (len(req.prompt) - 1) // self.slots.page_size + 1

    def _resumable(self) -> bool:
        return self.engine_cfg.resume and self.journal is not None

    def _admit_pending(self) -> bool:
        # Tick-boundary sweep: every dead queued request (lapsed
        # deadline, cancel, raced drain) resolves wherever it sits.
        swept = self.scheduler.sweep()
        # Slot pressure before the take: a strictly better-class arrival
        # claims a slot from the worst occupant (suspended, not lost).
        preempted = self._preempt_for_slots()
        # Page back-pressure: the take stops (requests wait, order kept)
        # when the next admission's pages — its prompt plus one growth
        # page, capped at the pool — would overdraw the free heap.
        budget = self.slots.free_pages
        reserved = 0

        def admit_fn(req):
            nonlocal reserved
            need = min(self._n_prompt_pages(req) + 1, self.slots.n_pages)
            if reserved + need > budget:
                return False
            reserved += need
            return True

        reqs = self.scheduler.take(
            self.slots.free_count,
            bucket_fn=lambda r: self._bucket(len(r.prompt)),
            admit_fn=admit_fn)
        if not reqs and self.scheduler.depth and self._resumable():
            # Page pressure: an empty take with a non-empty queue means
            # the head waits for pages.  If it outranks the worst
            # occupant, suspend that occupant so its pages free the head
            # next tick; within a class the head keeps waiting.
            best = self.scheduler.peek_best_rank()
            occ = self._occupants()
            if best is not None and occ:
                worst = max(occ)
                if worst[0] > best:
                    self._preempt(worst[2], "page_pressure")
        self._taken = list(reqs)
        live: List[Request] = []
        for req in reqs:
            if req.future.done():  # resolved while taken (raced a drain)
                self._taken.remove(req)
            elif req.future.cancel_requested:
                req.future._finish("cancelled")
                self.metrics.cancelled.inc()
                self._taken.remove(req)
            else:
                live.append(req)
        if live:
            self._admit_batch(live)
        self._taken = []
        return bool(reqs) or bool(swept) or preempted

    def _admit_batch(self, reqs: List[Request]) -> None:
        """Grant the prompt pages, run ONE batch-K prefill (one bucket),
        land its K/V with one scatter, and emit each first token.  A
        resumed request's prompt is its original prompt plus the tokens
        it emitted before, so the same prefill continues its stream."""
        faults = self.engine_cfg.faults
        if faults is not None:
            faults.probe("prefill")
        t_adm = time.monotonic()
        slots: List[int] = []
        live: List[Request] = []
        for req in reqs:
            if req.future.ttft is None:
                # Queue wait ends at the first admission; a resumed
                # re-admission keeps its first life's figures.
                self.metrics.observe_queue_wait(req.priority,
                                                t_adm - req.submitted_at)
            slot = self.slots.alloc()
            assert slot is not None  # take() is bounded by free_count
            try:
                for idx in range(self._n_prompt_pages(req)):
                    self.slots.grant(slot, idx)
            except CacheOutOfPagesError as e:
                self.slots.free(slot)  # returns whatever got granted
                req.future.set_exception(e)
                self.metrics.rejected.inc()
                self._taken.remove(req)
                continue
            slots.append(slot)
            live.append(req)
        if not live:
            return
        k = len(live)
        bucket = max(self._bucket(len(r.prompt)) for r in live)
        padded = np.zeros((k, bucket), np.int64)
        lens = np.zeros((k,), np.int64)
        for i, r in enumerate(live):
            padded[i, :len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt)
        dev = self.device
        cache = T.init_cache(self.cfg, k, bucket, device=dev)
        logits, pre = T.prefill(self.params, upload(padded, dev), cache,
                                self.cfg, true_len=upload(lens, dev))
        self._prefill_calls += 1
        self.slots.land(slots, pre, lens)
        firsts = self._first_tokens(live, logits)  # one sync for K
        self.metrics.host_syncs.inc()
        now = time.monotonic()
        for slot, req, first in zip(slots, live, firsts):
            if req.future.ttft is None:
                # A resumed request served its first token in an
                # earlier life; that TTFT stands.
                req.future.ttft = now - req.submitted_at
                self.metrics.observe_ttft(req.priority, req.future.ttft)
            self.metrics.admitted.inc()
            # The slot's columns land before the next dispatch (step()
            # admits first); a greedy request writes the zero row.
            self._samp.set(slot, temperature=req.temperature,
                           top_k=req.top_k, top_p=req.top_p, seed=req.seed)
            self._states[slot] = _SlotState(request=req,
                                            last_token=int(first),
                                            n_generated=0)
            self._page_pos[slot] = len(req.prompt)
            self._taken.remove(req)  # landed: _states owns it now
            self._emit(slot, int(first))
        if self._tokens_live:
            # Land the first tokens in the device token vector (a slot
            # that its first token retired is inactive: a don't-care).
            vals = np.zeros(self.engine_cfg.n_slots, np.int64)
            mask = np.zeros(self.engine_cfg.n_slots, bool)
            vals[slots] = firsts
            mask[slots] = True
            tok = self._tick.tokens
            tok.copy_(torch.where(upload(mask, dev), upload(vals, dev), tok))

    def _first_tokens(self, reqs: List[Request], logits) -> List[int]:
        """An admission group's first tokens from its prefill logits (the
        prefill is the first decode step): the argmax for an all-greedy
        group, else :func:`~horovod_tpu_torch.models.transformer.
        sample_token_rows` with each row's own parameters at key
        position ``len(prompt)`` (greedy rows still take the argmax).

        The logits get the decode tick's finiteness check (each row's
        max logit), fetched in the same host sync as the tokens: a
        non-finite row raises :class:`EngineFailedError` before any of
        the group's tokens is emitted.  (The JAX engine does not check
        prefill logits and emits the argmax of NaN.)"""
        if all(r.temperature <= 0.0 for r in reqs):
            toks = torch.argmax(logits, dim=-1)
        else:
            dev = self.device
            cols = [np.array([r.temperature for r in reqs], np.float32),
                    np.array([r.top_k for r in reqs], np.int64),
                    np.array([r.top_p for r in reqs], np.float32),
                    np.stack([seed_key(r.seed) for r in reqs]).astype(
                        np.int64),
                    np.array([len(r.prompt) for r in reqs], np.int64)]
            temp, tk, tp, keys, pos = (upload(c, dev) for c in cols)
            toks = T.sample_token_rows(logits, temp, tk, tp, keys, pos,
                                       torch.zeros_like(pos))
        finite = torch.isfinite(logits.amax(dim=-1))
        out = torch.cat([toks.long(), finite.long()]).tolist()
        if not all(out[len(reqs):]):
            raise EngineFailedError(
                "non-finite logits from prefill (bad params or device "
                "fault)")
        return out[:len(reqs)]

    # -- preemption --------------------------------------------------------

    def _occupants(self) -> List:
        """Every occupied slot as ``(priority rank, request id, slot,
        request)``: ``max()`` of the list is the preemption victim, the
        worst class and the youngest request within it."""
        return [(st.request.priority_rank, st.request.id, s, st.request)
                for s, st in enumerate(self._states) if st is not None]

    def _build_resume(self, req: Request) -> Optional[Request]:
        """A resume request for ``req`` from its journal frontier —
        prompt + emitted tokens as the new prompt, the remaining decode
        budget, and the original id, ``submitted_at``, deadline, class,
        sampling parameters and future — or None when no frontier
        exists (``resume=False``, no journal entry, nothing left to
        decode).  Shared by the restart path and preemption."""
        if not self._resumable():
            return None
        entry = self.journal.get(req.id)
        if entry is None or entry.remaining < 1:
            return None
        new = Request(prompt=list(entry.prompt) + list(entry.emitted),
                      max_new_tokens=entry.remaining, future=req.future,
                      eos_id=entry.eos_id, deadline=req.deadline,
                      trace=req.trace, temperature=entry.temperature,
                      top_k=entry.top_k, top_p=entry.top_p, seed=entry.seed,
                      priority=req.priority)
        # The original id is the journal key and keeps the request's age
        # in the scheduling order (victims are picked by id).
        new.id = req.id
        new.submitted_at = req.submitted_at
        # Wasted work: tokens prefilled a second time.  A request that
        # never landed a prefill requeues for free.
        new._resume_wasted = len(new.prompt) if entry.emitted else 0
        return new

    def _preempt(self, slot: int, reason: str) -> bool:
        """Suspend the request in ``slot``: its pages and slot freed, its
        journal frontier kept, a resume request requeued with the future
        still live, so its tokens stay those of an uninterrupted run.
        Without a frontier (``resume=False``) the future fails with
        :class:`CacheOutOfPagesError`.  True if the slot was vacated."""
        st = self._states[slot]
        if st is None:
            return False
        req = st.request
        fut = req.future
        self._release(slot)
        if fut.done():
            return True
        if fut.cancel_requested:
            fut._finish("cancelled")
            self.metrics.cancelled.inc()
            return True
        new = self._build_resume(req)
        if new is None:
            fut.set_exception(CacheOutOfPagesError(
                f"preempted ({reason}); no resume frontier — retry with "
                "backoff"))
            self.metrics.rejected.inc()
            return True
        self.metrics.preemptions.inc()
        if new._resume_wasted:
            self.metrics.resume_wasted_tokens.inc(new._resume_wasted)
        self.journal.note_resume(req.id)
        # Back into the queue (exempt from its depth bound: the caller is
        # still waiting); the page budget keeps it waiting until the
        # pressure that evicted it clears.
        self.scheduler.requeue_front([new])
        self.metrics.queue_depth.set(self.scheduler.depth)
        return True

    def _evict_for_pages(self) -> bool:
        """Preempt one victim to reclaim pages: the worst class first,
        the youngest within it.  False when no slot is occupied."""
        occ = self._occupants()
        if not occ:
            return False
        return self._preempt(max(occ)[2], "out_of_pages")

    def _preempt_for_slots(self) -> bool:
        """Slot pressure: every slot busy and a strictly better-class
        request waiting — suspend the worst occupant so the winner
        admits this tick.  Never within a class, never without a resume
        frontier to suspend onto."""
        if not self._resumable():
            return False
        if self.slots.free_count > 0 or self.scheduler.depth == 0:
            return False
        best = self.scheduler.peek_best_rank()
        occ = self._occupants()
        if best is None or not occ:
            return False
        worst = max(occ)
        if worst[0] <= best:
            return False  # nothing strictly better is waiting
        return self._preempt(worst[2], "slot_pressure")

    def _prepare_paged_tick(self) -> None:
        """Tick-boundary page maintenance: every active slot gets a page
        under its write position (preempting on exhaustion), then the
        tick's table is refreshed iff it changed."""
        ps = self.slots.page_size
        for s in range(self.engine_cfg.n_slots):
            st = self._states[s]
            if st is None:
                continue
            wp = int(self._page_pos[s])
            last_real = len(st.request.prompt) + st.request.max_new_tokens - 2
            if wp > min(last_real, self.slots.max_len - 1):
                continue
            self._claim_page(s, wp // ps)
        if self._table_uploaded != self.slots.table_version:
            upload_into(self._tick.table, self.slots.table)
            self._table_uploaded = self.slots.table_version

    def _claim_page(self, slot: int, idx: int) -> bool:
        """Grant ``slot`` a page at table index ``idx``, preempting
        victims while the pool is exhausted.  False when ``slot`` itself
        was the victim."""
        while self.slots.table[slot, idx] == NULL_PAGE:
            try:
                self.slots.grant(slot, idx)
            except CacheOutOfPagesError:
                self._evict_for_pages()
                if self._states[slot] is None:
                    return False
        return True

    def _emit(self, slot: int, tok: int) -> None:
        """Stream one token to the slot's future and journal it; retire
        on EOS, max-token, capacity or a lapsed deadline."""
        st = self._states[slot]
        if st is None:
            return
        if not st.request.future._add_token(tok):
            self._release(slot)  # resolved elsewhere
            return
        if self.journal is not None:
            # The journal mirrors the future: a token is recorded iff the
            # caller sees it, so a resume's prompt + emitted is exactly
            # the oracle's state.
            self.journal.append(st.request.id, tok)
        st.last_token = tok
        st.n_generated += 1
        self.metrics.tokens_generated.inc()
        req = st.request
        reason = None
        if req.eos_id is not None and tok == req.eos_id:
            reason = "eos"
        elif st.n_generated >= req.max_new_tokens:
            reason = "length"
        elif len(req.prompt) + st.n_generated - 1 >= self.slots.max_len:
            reason = "capacity"  # submit() sizing makes this unreachable
        elif req.deadline is not None and time.monotonic() > req.deadline:
            reason = "deadline"
        if reason is not None:
            req.future._finish(reason)
            self.metrics.completed.inc()
            self._release(slot)

    def _host_tokens(self) -> np.ndarray:
        tokens = np.zeros(self.engine_cfg.n_slots, np.int64)
        for s, st in enumerate(self._states):
            if st is not None:
                tokens[s] = st.last_token
        return tokens

    def _dispatch(self, active: np.ndarray, t0: float) -> Dict:
        """Refresh the tick's mask (iff it changed) and sampling columns
        (iff dirty), run one tick over all slots, and start fetching its
        next tokens and per-slot max logit.  Returns the pending record
        :meth:`_retire_pending` applies."""
        if (self._active_uploaded is None
                or not np.array_equal(active, self._active_uploaded)):
            upload_into(self._tick.active, active)
            self._active_uploaded = active
        self._samp.device()
        faults = self.engine_cfg.faults
        kind = faults.probe("decode_tick") if faults is not None else None
        nxt, mx = self._tick.run()
        fetch = download(nxt, mx)
        self._page_pos += active
        self.metrics.decode_ticks.inc()
        self.metrics.tick_dispatch.observe(time.monotonic() - t0)
        return {"fetch": fetch, "active": active, "dispatched_at": t0,
                "kind": kind,
                "reqs": [st.request if st is not None else None
                         for st in self._states]}

    def _decode_tick(self) -> bool:
        """The synchronous tick (``overlap=False``, the A/B baseline):
        upload the tokens, dispatch, fetch and emit in the same step."""
        if self.slots.active_count:
            self._prepare_paged_tick()
        active = self.slots.active_mask()
        if not active.any():
            return False
        t0 = time.monotonic()
        upload_into(self._tick.tokens, self._host_tokens())
        self._retire_pending(self._dispatch(active, t0))
        return True

    def _decode_tick_overlapped(self) -> bool:
        """One pipelined decode step (``overlap=True``): dispatch tick
        N+1 first — its token input is tick N's output, already on the
        device — then fetch and apply tick N's results while the device
        computes tick N+1."""
        worked = False
        if self.slots.active_count:
            # Page grants (and preemptions) before the mask snapshot:
            # host bookkeeping and a non-blocking table copy.
            self._prepare_paged_tick()
        active = self.slots.active_mask()
        new_pending = None
        if active.any():
            t0 = time.monotonic()
            if not self._tokens_live:
                # Pipeline (re)start: seed the device token vector from
                # the host; after this the tick feeds itself.
                upload_into(self._tick.tokens, self._host_tokens())
                self._tokens_live = True
            new_pending = self._dispatch(active, t0)
            worked = True
        prev, self._pending = self._pending, new_pending
        self._unchecked_dispatch = prev is None and new_pending is not None
        if prev is not None:
            self._retire_pending(prev)
            worked = True
        return worked

    def _retire_pending(self, p: Dict) -> None:
        """Fetch a dispatched tick's results — the one host sync of a
        steady-state step — check them and emit, for both modes.

        A slot's token is emitted only if the slot still holds the
        request it computed for at dispatch (the ``reqs`` snapshot).  A
        slot retired (EOS, length, deadline), cancelled, preempted or
        re-admitted between dispatch and fetch fails that check and its
        stale row is dropped: no token after EOS, and no token leaks into
        a slot's next tenant.  The stale row's K/V write is never read
        (write before attend).  In the synchronous tick the snapshot
        always matches."""
        faults = self.engine_cfg.faults
        if faults is not None:
            faults.probe("decode_fetch")
        t0 = time.monotonic()
        nxt, mx = p["fetch"].wait()
        self.metrics.host_syncs.inc()
        t1 = time.monotonic()
        self.metrics.tick_device_wait.observe(t1 - t0)
        active = p["active"]
        if p["kind"] == "nonfinite":
            # Injected: NaN logits, applied to the fetched host copy
            # (never inside the captured graph).
            mx = np.where(active, np.nan, mx)
        if not np.isfinite(mx[active]).all():
            raise EngineFailedError(
                "non-finite logits from decode tick (bad params or device "
                "fault)")
        lat = t1 - p["dispatched_at"]
        for s in np.nonzero(active)[0]:
            s = int(s)
            st = self._states[s]
            if st is None or st.request is not p["reqs"][s]:
                continue  # retired or re-admitted since dispatch: stale
            self.metrics.token_latency.observe(lat)
            self._emit(s, int(nxt[s]))
        self.metrics.tick_host.observe(time.monotonic() - t1)

    # -- failure recovery --------------------------------------------------

    def _fail_inflight(self, exc: BaseException) -> None:
        """Resolve every in-flight future (slots + taken-but-unlanded)
        with ``exc`` and reset the slot bookkeeping: the terminal path,
        where nothing resumes (each resolution purges its journal
        entry)."""
        for st in self._states:
            if st is not None:
                st.request.future.set_exception(exc)
        for req in self._taken:
            req.future.set_exception(exc)
        self._clear_inflight_state()

    def _suspend_inflight(self, exc: BaseException) -> List[Request]:
        """The non-terminal restart path: every in-flight request (slots
        + taken-but-unlanded) as a resume request with its original
        future, then the slot bookkeeping reset.  Requests that cannot
        resume are resolved in place.  Returned in submission order."""
        pending = [st.request for st in self._states if st is not None]
        pending += list(self._taken)
        resumed = [r for r in (self._resume_or_fail(req, exc)
                               for req in pending) if r is not None]
        self._clear_inflight_state()
        resumed.sort(key=lambda r: r.id)
        self._resuming = len(resumed)
        return resumed

    def _resume_or_fail(self, req: Request,
                        exc: BaseException) -> Optional[Request]:
        fut = req.future
        if fut.done():
            return None  # resolved elsewhere (drain race, hard fail)
        if fut.cancel_requested:
            fut._finish("cancelled")
            self.metrics.cancelled.inc()
            return None
        entry = self.journal.get(req.id) if self.journal is not None \
            else None
        if entry is not None and self.engine_cfg.resume \
                and entry.remaining < 1:
            # Fully emitted: only the retirement was lost — finish now.
            fut._finish("length")
            self.metrics.completed.inc()
            return None
        # Decode, greedy and sampled, is a function of the token
        # sequence, so prefilling prompt + emitted and continuing gives
        # an uninterrupted run's tokens.
        new = self._build_resume(req)
        if new is None:
            fut.set_exception(exc)
        return new

    def _clear_inflight_state(self) -> None:
        """Reset slot bookkeeping after a failure, the allocator included
        (host only: a terminal engine reports no phantom occupancy)."""
        self._taken = []
        self._states = [None] * self.engine_cfg.n_slots
        self.slots.release_all()
        self._reset_pipeline()

    def _reset_pipeline(self) -> None:
        """Drop the dispatched-but-unfetched tick and the device-resident
        token state; the next dispatch reseeds from host slot state.

        The dropped tick's pinned buffers and event are never waited on.
        Its replay may still be running: everything the engine enqueues
        afterwards (the in-place reset of :meth:`_restart`, the resumed
        prefills and landings) goes on the same stream behind it, so
        stream order keeps them from racing it, and the caching host
        allocator holds its pinned buffers until its copies are done."""
        self._pending = None
        self._tokens_live = False
        self._unchecked_dispatch = False
        self._table_uploaded = -1
        self._active_uploaded = None
        self._page_pos[:] = 0
        # Zero host rows; re-admissions, resumes included, set theirs
        # before the next dispatch uploads them.
        self._samp.reset()

    def _fail_queue(self, exc: BaseException) -> None:
        for req in self.scheduler.drain_pending():
            req.future.set_exception(exc)

    def _go_terminal(self, exc: BaseException) -> None:
        """Terminally ``failed``: every in-flight and queued future
        resolved with ``exc``.  Caller holds ``_lock``.  The state flips
        first, so whoever a resolution wakes already sees ``failed``."""
        self._terminal = True
        self.error = self.error or f"{type(exc).__name__}: {exc}"
        self._set_health(FAILED)
        self._fail_inflight(exc)
        self._fail_queue(exc)
        self.metrics.queue_depth.set(0)
        self.metrics.slot_occupancy.set(0.0)

    def _recover(self, exc: BaseException, *, counted: bool = False) -> None:
        """The supervised restart.  With ``resume`` (the default) the
        in-flight requests are suspended and requeued after the restart
        with their futures live; without it (or when the resume
        machinery fails) they fail typed.  Past ``max_restarts``
        consecutive failures — or when the in-place reset itself raises,
        as it does once a sticky CUDA error has poisoned the context —
        the engine goes terminally ``failed`` instead."""
        if not isinstance(exc, EngineFailedError):
            wrapped = EngineFailedError(f"engine tick failed: {exc!r}")
            wrapped.__cause__ = exc
            exc = wrapped
        with self._hb_lock:
            self._stalled = False
        if not counted:
            self.metrics.engine_failures.inc()
        with self._lock:
            self._consec_failures += 1
            attempt = self._consec_failures
            if (self._terminal
                    or attempt > self.engine_cfg.max_restarts):
                self._go_terminal(exc)
                return
            resume_ok = True
            faults = self.engine_cfg.faults
            if faults is not None:
                try:
                    faults.probe("restart_resume")
                except Exception:
                    # The resume machinery itself failed: degrade to the
                    # fail-typed restart, never replay untrusted state.
                    resume_ok = False
            if resume_ok:
                resumed = self._suspend_inflight(exc)
            else:
                resumed = []
                self._fail_inflight(exc)
        time.sleep(min(
            self.engine_cfg.restart_backoff * (2.0 ** (attempt - 1)),
            self.engine_cfg.restart_backoff_max))
        with self._lock:
            # terminate() may have landed during the backoff: a terminal
            # declaration is never undone by a restart.
            if self._terminal:
                for req in resumed:
                    req.future.set_exception(exc)
                self._resuming = 0
                self._set_health(FAILED)
                self._fail_queue(exc)
                return
            try:
                self._restart()
            except Exception as reset_exc:
                # A sticky device error (an illegal address, a failed
                # launch) makes every later call raise: no restart can
                # succeed, so go terminal now rather than spending the
                # budget on it.
                err = EngineFailedError(
                    f"engine restart failed: {reset_exc!r}")
                err.__cause__ = reset_exc
                for req in resumed:
                    req.future.set_exception(err)
                self._resuming = 0
                self._go_terminal(err)
                return
            self._resuming = 0
            if resumed:
                # Back to the head of the queue in submission order: the
                # next tick re-prefills prompt + emitted through the
                # ordinary admission and decode continues.
                self.scheduler.requeue_front(resumed)
                for req in resumed:
                    self.metrics.resumed.inc()
                    if req._resume_wasted:
                        self.metrics.resume_wasted_tokens.inc(
                            req._resume_wasted)
                    self.journal.note_resume(req.id)
                self.metrics.queue_depth.set(self.scheduler.depth)

    def _restart(self) -> None:
        """A fresh cache and slot bookkeeping, reset in place: the
        captured tick reads the pool and its inputs by address, so they
        are zeroed where they lie and the graph is not recaptured.
        Queued requests survive.  Caller holds ``_lock``.  The restart
        target is ``draining`` if a drain began (sticky across a stall),
        else ``degraded``."""
        self.slots.reset()
        self._tick.reset_inputs()
        self._states = [None] * self.engine_cfg.n_slots
        self._reset_pipeline()
        self._update_page_gauges()
        with self._hb_lock:
            self._epoch += 1
            self._stalled = False
            self._stall_hard_failed = False
        self.metrics.engine_restarts.inc()
        self._set_health(DRAINING if self._draining else DEGRADED)

    # -- watchdog ----------------------------------------------------------

    def _stall_grace_s(self) -> float:
        g = self.engine_cfg.stall_grace
        return g if g is not None else self.engine_cfg.tick_timeout

    def _watchdog_loop(self) -> None:
        budget = self.engine_cfg.tick_timeout
        while not self._stop.is_set():
            time.sleep(self.engine_cfg.watchdog_interval)
            with self._hb_lock:
                started = self._tick_started
                epoch = self._epoch
                stalled = self._stalled
                hard = self._stall_hard_failed
            if started is None:
                continue
            age = time.monotonic() - started
            if not stalled:
                if age > budget:
                    self._declare_stalled(epoch, started)
            elif (self.engine_cfg.resume and not hard
                    and age > budget + self._stall_grace_s()):
                # The stall outlived its grace: presume the tick never
                # returns and resolve everything.
                self._stall_hard_fail(epoch, started)

    def _stall_exc(self, with_grace: bool) -> EngineStalledError:
        msg = (f"engine stalled: tick exceeded the "
               f"{self.engine_cfg.tick_timeout}s watchdog budget")
        if with_grace:
            msg += f" plus the {self._stall_grace_s()}s resume grace"
        return EngineStalledError(msg)

    def _resolve_frozen(self, exc: BaseException) -> None:
        """Resolve every future a hung tick would strand, in flight and
        queued, from the watchdog thread: the engine thread is hung
        inside ``_lock``, so the slot state is read without it."""
        for st in list(self._states):
            if st is not None:
                st.request.future.set_exception(exc)
        for req in list(self._taken):
            req.future.set_exception(exc)
        self._fail_queue(exc)

    def _declare_stalled(self, epoch: int, started: float) -> None:
        """The tick has run past its budget: a hung device call.  On the
        watchdog thread, which never takes ``_lock`` and never touches
        the device; it only resolves futures and flips flags.  With
        ``resume`` the in-flight futures are held: a tick that returns
        within ``stall_grace`` resumes them through the restart."""
        with self._hb_lock:
            if (self._stalled or self._epoch != epoch
                    or self._tick_started != started):
                return  # the tick finished or recovery already ran
            self._stalled = True
        self.metrics.engine_failures.inc()
        self._set_health(FAILED)
        if self.engine_cfg.resume:
            return  # held for resume; hard fail at budget + grace
        self._resolve_frozen(self._stall_exc(False))

    def _stall_hard_fail(self, epoch: int, started: float) -> None:
        """The stalled tick spent its grace too: resolve every future
        typed.  Each resolution purges its journal entry, so a tick that
        returns even later finds nothing to resume."""
        with self._hb_lock:
            if (self._stall_hard_failed or not self._stalled
                    or self._epoch != epoch
                    or self._tick_started != started):
                return
            self._stall_hard_failed = True
        self._resolve_frozen(self._stall_exc(True))

    # -- background loop ---------------------------------------------------

    def start(self, idle_sleep: float = 0.001) -> None:
        """Run the tick loop in a daemon thread until :meth:`stop`; arm
        the watchdog when ``tick_timeout > 0``.  A failing tick never
        ends the loop (``step`` recovers); a terminal engine idles."""
        if self._thread is not None:
            return

        def loop():
            while not self._stop.is_set():
                if not self.step():
                    time.sleep(idle_sleep)

        self._stop.clear()
        self._thread = threading.Thread(target=loop, name="serving-engine",
                                        daemon=True)
        self._thread.start()
        if self.engine_cfg.tick_timeout > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="serving-watchdog",
                daemon=True)
            self._watchdog.start()

    def stop(self, timeout: float = 10.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        self._thread = None
        if self._watchdog is not None:
            self._watchdog.join(timeout)
            self._watchdog = None

    def warmup(self, prompt_lens: Sequence[int] = (1,)) -> None:
        """Capture the decode tick (CUDA), then drive the engine
        synchronously through one admission per (prompt bucket, batch
        k <= max_prefills_per_tick) and its decode ticks — on the card
        this builds both kernels and warms their launch paths before
        real traffic.  Call it before :meth:`start`: no other thread
        touches the card during the capture.  The sweep's synthetic
        requests are kept out of the journal."""
        with self._lock:
            self._tick.capture()
        kmax = min(self.engine_cfg.max_prefills_per_tick,
                   self.engine_cfg.n_slots)
        journal, self.journal = self.journal, None
        try:
            for n in prompt_lens:
                for k in range(1, kmax + 1):
                    futs = [self.submit([0] * max(int(n), 1),
                                        max_new_tokens=2)
                            for _ in range(k)]
                    while not all(f.done() for f in futs):
                        self.step()
            while self._pending is not None:  # the pipeline's last tick
                self.step()
        finally:
            self.journal = journal

    def drain(self, timeout: float = 60.0, poll: float = 0.002) -> bool:
        """Block until the queue, the slots and the pipeline are empty
        (True) or timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._health == FAILED:
                with self._hb_lock:
                    hard = self._stall_hard_failed
                if self._terminal or hard or not self.engine_cfg.resume:
                    return True  # everything is already resolved
                # Otherwise a stall window with resume on: journaled
                # requests may still resume, so keep waiting.
            # A timed acquire: a hung tick holds _lock, and drain must
            # keep checking its own deadline.
            if self._lock.acquire(timeout=poll):
                try:
                    idle = (self.scheduler.depth == 0
                            and self.slots.active_count == 0
                            and not self._taken and self._pending is None
                            and self._resuming == 0)
                finally:
                    self._lock.release()
                if idle:
                    return True
            if self._thread is None:
                self.step()
            else:
                time.sleep(poll)
        return False

    def terminate(self, reason: str = "engine terminated") -> None:
        """Resolve everything with :class:`EngineFailedError` and go
        terminally ``failed`` (the drain-timeout escape hatch).  Without
        the step lock (a hung tick holds it) the futures are resolved
        anyway; ``_terminal`` keeps a late tick from restarting."""
        self._terminal = True
        self.error = self.error or reason
        exc = EngineFailedError(reason)
        locked = self._lock.acquire(timeout=1.0)
        try:
            self._fail_inflight(exc)
            self._fail_queue(exc)
        finally:
            if locked:
                self._lock.release()
        self._set_health(FAILED)

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict:
        age = self.heartbeat_age
        return {
            **self.metrics.snapshot(),
            "state": self._health,
            "queue_depth": int(self.scheduler.depth),
            "occupancy": float(self.slots.occupancy),
            "engine_state": str(self._health),
            "heartbeat_age_s": round(age, 3) if age is not None else -1.0,
            "state_transitions": self.state_transitions,
            "error": self.error,
            "device": str(self.device),
            "n_slots": self.engine_cfg.n_slots,
            "slots_active": self.slots.active_count,
            "max_len": self.slots.max_len,
            "prefill_calls": self._prefill_calls,
            "page_size": self.slots.page_size,
            "kv_dtype": str(self.slots._storage_dtype).replace("torch.", ""),
            "kv_pages_high_water": self.slots.pages_high_water,
            "overlap": self.engine_cfg.overlap,
            "resume": self.engine_cfg.resume,
            "journal_inflight":
                len(self.journal) if self.journal is not None else 0,
            # Captures of the decode tick's CUDA graph (0 on the CPU,
            # where the tick runs eagerly): 1 after warmup, whatever the
            # request mix and however many restarts.  The first-token
            # sampler runs eagerly.
            "decode_compilations": self._tick.captures,
            "sample_compilations": 0,
            # Process-wide kernel launch counts (CPU runs take the plain
            # versions and leave them at 0).
            "flash_fwd_launches": _attn.flash_fwd_launches,
            "paged_attend_launches": _pa.paged_attend_launches,
        }
