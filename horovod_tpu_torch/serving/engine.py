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
   that share one admission group (:meth:`InferenceEngine._group_key`:
   the prompt bucket — prompts right-padded to a power of two, at least
   ``min_prefill_bucket`` — and the matched shared prefix), map each
   its pages, run ONE batch-K prefill (flash kernel K1 on the card) and
   land its K/V in the pages.  The prefill's last-position logits give
   each request its first token: the argmax for an all-greedy group,
   else the sampler at key position ``len(prompt)``.  On CUDA the
   prefill, its landing and the argmax are one replay of a
   :class:`~horovod_tpu_torch.serving.graph.PrefillGraphs` graph per
   ``("full", bucket, k)`` (the JAX engine's compiled prefill per
   bucket), the sampler one more per ``("sample", k)``; a key is
   captured at :meth:`~InferenceEngine.warmup` or at its first use, as
   the JAX engine jits at first use.  Admission order is
   the scheduler's: priority class (``interactive`` before ``batch``),
   then earliest deadline, then submission.
2. **Decode**: give every decoding slot a private page under its next
   write position (granted, or copied from a shared one), then ONE :class:`~horovod_tpu_torch.serving.graph.
   DecodeTick` over all S slots — ``decode_step_paged`` (paged-attention
   kernel K4 on the card) and the per-slot sampled pick — with the page
   table, the active mask and the sampling columns as data.  On CUDA the
   tick is one CUDA graph captured at :meth:`~InferenceEngine.warmup`
   (or at the first tick) and replayed; ``decode_compilations`` counts
   captures and stays 1 across any request mix and any number of
   restarts.

Shared prefixes (:meth:`InferenceEngine.register_prefix`): a registered
prefix (a system prompt) is prefilled once into pinned pages; a request
whose prompt starts with it attaches those pages (a refcount, no copy)
and prefills only its suffix
(:func:`~horovod_tpu_torch.models.transformer.prefill_with_prefix`, K1
with ``shift = -len(prefix)`` read from the device, one graph per
``("suffix", prefix pages, bucket, k)``: the prefix's page ids are
NULL-padded to a power-of-two count, so every prefix length of a
page-count bucket shares a graph); one whose prompt is the prefix admits
with no prefill at all.  A slot about to write into a shared page copies
it first (:meth:`~horovod_tpu_torch.serving.cache.PagedSlotCache.cow`,
in place inside the pool tensors the captured tick reads).  A restart
resets the pool, and with it the pins: entries re-prefill, once, at
their next use.

Chunked prefill (``EngineConfig.prefill_chunk_tokens``): a prompt whose
unshared part exceeds the chunk is ingested chunk by chunk, one chunk
riding each tick; every chunk after the first runs ``prefill_with_prefix``
over the slot's landed pages (K1 with ``shift = -landed``), through the
suffix graph of the landed pages' power-of-two count, so chunk
boundaries stay data.  The slot is
left out of the tick's active mask until its last chunk yields the
first token, so the other slots keep decoding; the tokens equal a
whole-prompt prefill's.

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

Speculative decoding (``EngineConfig.speculative``, as in the JAX
engine): each tick drafts ``spec_k`` tokens a slot — by prompt lookup
over a device-resident token history (``spec_draft="ngram"``), or with a
shallower draft model over its own slot-aligned paged pool
(``"model"``: ``InferenceEngine(draft_params=, draft_cfg=)``) — and
verifies them in one W-wide forward (``W = spec_k + 1``; the committed
pages through K4 at ``R = G * W``).  A slot emits its accepted drafts
plus the target's own next token, 1 to ``W`` tokens a tick, always the
target's greedy continuation, so the tokens equal the plain engine's.
The speculative tick is one more CUDA graph
(:class:`~horovod_tpu_torch.serving.graph.SpecTick`) beside the plain
tick, which a tick where no slot speculates replays instead (every
request opted out with ``submit(speculative=False)``, sampled, or its
slot disabled by the adaptive control: a slot whose acceptance over
``spec_window`` ticks falls under ``spec_min_acceptance`` stops
speculating, and is probed again every ``spec_probe_period`` ticks).
The host learns a slot's accepted length one tick late, so with a
speculative tick in flight the page grants cover ``2W - 1`` positions
ahead and the host mirror of the positions advances at fetch.

Faults for tests come from
:class:`~horovod_tpu_torch.serving.faults.FaultInjector`
(``EngineConfig.faults``), probed at the JAX engine's sites: ``watchdog``
(top of a step), ``prefill`` (admission), ``prefill_chunk`` (before each
chunk of a chunked prompt), ``decode_tick`` (before a tick runs;
``nonfinite`` poisons that tick's fetched max logits on the host),
``decode_fetch`` (before a tick's results are fetched) and
``restart_resume`` (in the restart path).

Tracing, as in the JAX engine (:mod:`horovod_tpu_torch.obs.tracing`):
every request carries a :class:`~horovod_tpu_torch.obs.tracing.
RequestTrace` (trace and span ids, the stage stamps, the ticks that
emitted to it), and its future's :meth:`~GenerationFuture.breakdown`
(queue wait, prefill, decode, host-sync lag) is final at resolution.
The tracer and the span recorder active at submit ride the future: the
request's span opens at submit, its typed events (``eviction``,
``spec_fallback``, ``engine_restart``, ``resume``) go through that
recorder, and resolution writes the finish record and the
tail-sampling verdict from whichever thread resolves.  Tick phases
(``tick_dispatch``, ``tick_device_wait``, ``tick_host``) and lifecycle
instants (``engine_failed``, ``engine_restart``, ``requests_resumed``,
``watchdog_stall``, ``stall_hard_fail``) go to the active tracer.  With
neither active, a tick pays the module-global reads and one attribute
read per slot.  Each capture counts ``xla_compiles_total{fn=}`` under
the JAX function names (:mod:`~horovod_tpu_torch.serving.graph`).
``EngineConfig.model_flops_per_token`` turns the token rate into
``serving_achieved_flops_per_sec``, refreshed by :meth:`~InferenceEngine.
stats` and by a ``/metrics`` scrape.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.obs import tracing as obs_tracing
from horovod_tpu_torch.ops import attention as _attn
from horovod_tpu_torch.ops import paged_attention as _pa
from horovod_tpu_torch.serving.cache import NULL_PAGE, PagedSlotCache, \
    pad_pages
from horovod_tpu_torch.serving.faults import FaultInjector
from horovod_tpu_torch.serving.graph import (
    DecodeTick,
    PrefillGraphs,
    SpecTick,
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
           "HEALTHY", "DEGRADED", "DRAINING", "FAILED"]

# Lifecycle states (the /healthz vocabulary): healthy and degraded (just
# restarted, not yet proven by a clean tick) serve traffic; draining and
# failed reject new work.
HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
FAILED = "failed"


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
        # The request's trace record (stamped as it moves through the
        # engine) and the tracer and span recorder active at submit:
        # resolution emits the request span, the JSONL line and the
        # span finish through them, from whichever thread resolves.
        self.trace: Optional[obs_tracing.RequestTrace] = None
        self._tracer: Optional[obs_tracing.Tracer] = None
        self._spans: Optional[obs_tracing.SpanRecorder] = None
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
            if self.trace is not None:
                self.trace.finished_at = time.monotonic()
                self.trace.finish = reason
                self.trace.tokens = len(self._tokens)
            self._done.set()
        self._emit_trace()
        self._fire_resolve()

    def set_exception(self, exc: BaseException) -> None:
        with self._resolve_lock:
            if self._done.is_set():
                return
            self._exc = exc
            if self.trace is not None:
                self.trace.finished_at = time.monotonic()
                self.trace.error = type(exc).__name__
                self.trace.tokens = len(self._tokens)
            self._done.set()
        self._emit_trace()
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

    def _emit_trace(self) -> None:
        # Outside _resolve_lock (file and queue IO must not serialize
        # resolution); only the resolving thread gets here, once.
        tp, tr = self._tracer, self.trace
        if tp is not None and tr is not None:
            try:
                tp.request_done(tr)
            except Exception:  # pragma: no cover - tracing must not fail work
                pass
        sp = self._spans
        if sp is not None and tr is not None:
            # The finish record and the tail-sampling verdict on the
            # buffered detail spans.
            try:
                sp.request_done(tr)
            except Exception:  # pragma: no cover - spans must not fail work
                pass

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None

    def breakdown(self) -> Optional[Dict]:
        """The request's timing breakdown (queue wait, prefill, decode,
        host-sync lag): final once the future resolves, measured up to
        now while it runs."""
        return self.trace.breakdown() if self.trace is not None else None

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
    docstring), ``False`` as the synchronous tick;
    ``prefill_chunk_tokens`` caps the prompt tokens one tick spends on
    ingestion: a prompt whose unshared part is longer is ingested chunk
    by chunk, one chunk a tick, while the other slots decode (0, the
    default, prefills whole prompts).

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
    the engine's fault sites (tests only).

    Speculative decoding, the JAX engine's knobs and defaults:
    ``speculative`` turns it on; ``spec_k`` drafts a slot a tick;
    ``spec_draft`` picks the draft source, ``"model"`` (needs
    ``InferenceEngine(draft_params=, draft_cfg=)``, a config of the same
    vocabulary), ``"ngram"`` (prompt lookup) or ``"auto"`` (the model
    when draft parameters are given); ``draft_n_pages`` sizes the draft
    model's page pool (0 = capacity parity); ``spec_adaptive`` disables
    a slot's speculation when its acceptance over ``spec_window`` ticks
    falls under ``spec_min_acceptance``, and re-enables it for a probe
    window every ``spec_probe_period`` ticks.  The JAX check that
    speculation needs ``paged=True`` has no counterpart: the port is
    paged only.

    ``model_flops_per_token`` (e.g. ``obs.xprof.
    transformer_flops_per_token(params)``) turns the token rate into
    ``serving_achieved_flops_per_sec`` (None disables), as in the JAX
    engine.

    Self-tuning and rollouts, the JAX engine's knobs and defaults:
    ``page_grant_ahead`` grants that many pages past the plain tick's
    write position at each tick boundary (page-table data only; capped
    at the request's last real write); ``autotune`` installs the online
    :class:`~horovod_tpu_torch.tuning.tuner.OnlineTuner` at the end of
    :meth:`InferenceEngine.warmup`, over the knob values whose graphs
    the warmup captured; ``config_generation`` is the fleet rollout's
    label, echoed by :meth:`InferenceEngine.stats` and never read by the
    engine."""

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
    prefill_chunk_tokens: int = 0
    max_restarts: int = 3
    restart_backoff: float = 0.05
    restart_backoff_max: float = 2.0
    tick_timeout: float = 60.0
    watchdog_interval: float = 0.05
    resume: bool = True
    journal_path: Optional[str] = None
    stall_grace: Optional[float] = None
    faults: Optional[FaultInjector] = None
    speculative: bool = False
    spec_k: int = 4
    spec_draft: str = "auto"
    draft_n_pages: int = 0
    spec_adaptive: bool = True
    spec_min_acceptance: float = 0.25
    spec_window: int = 2
    spec_probe_period: int = 256
    model_flops_per_token: Optional[float] = None
    page_grant_ahead: int = 0
    autotune: bool = False
    config_generation: int = 0


@dataclasses.dataclass
class _SlotState:
    request: Request
    last_token: int
    n_generated: int


@dataclasses.dataclass
class _IngestState:
    """A slot whose prompt is landing chunk by chunk: the request, how
    many prompt tokens its pages hold (``landed``, an attached prefix
    included: the next chunk starts there) and where ingestion began
    (``started``, the attached prefix's length), so ``landed - started``
    is the prefill a suspension throws away.  The slot holds pages and
    occupancy but is out of the decode mask until its last chunk
    yields the first token."""

    request: Request
    landed: int
    started: int = 0


@dataclasses.dataclass
class _PrefixEntry:
    """A registered shared prefix: its tokens, the pages its K/V lives
    in (pinned by the registry), its first greedy token and its
    last-position logits on the device (a copy: the graph's output is
    rewritten by the next replay; a prompt that is the prefix admits
    with no prefill: greedy from the token, sampled by drawing from the
    logits), and the cache epoch the pages belong to (a restart
    resets the pool; a stale entry re-prefills at its next use)."""

    tokens: tuple
    pages: Optional[List[int]] = None
    first_token: int = 0
    logits: Optional[torch.Tensor] = None
    epoch: int = -1


class InferenceEngine:
    """Continuous-batching engine over one model's params + config.

    Drive it synchronously with :meth:`step` or as a background thread
    with :meth:`start` / :meth:`stop` (the HTTP server; this also arms
    the watchdog).  The engine runs on CUDA unless ``device="cpu"`` is
    passed; ``params`` must already live on that device
    (:func:`~horovod_tpu_torch.models.transformer.init_params`,
    :func:`~horovod_tpu_torch.models.convert.params_from_jax`); so must
    ``draft_params``, a speculative engine's draft model (``draft_cfg``
    its configuration, of the target's vocabulary)."""

    def __init__(self, params: Dict, cfg: T.TransformerConfig,
                 engine_cfg: EngineConfig = EngineConfig(), *, device=None,
                 draft_params: Optional[Dict] = None,
                 draft_cfg: Optional[T.TransformerConfig] = None):
        self.device = T.resolve_device(device)
        for name, tree in (("params", params), ("draft_params",
                                                draft_params)):
            if tree is not None and \
                    tree["embed"].device.type != self.device.type:
                raise ValueError(
                    f"{name} live on {tree['embed'].device}, the engine on "
                    f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        ec = engine_cfg
        # Speculative decoding: the draft source is resolved up front.
        self._spec = ec.speculative
        self._spec_model = False
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        if self._spec:
            if ec.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {ec.spec_k}")
            mode = ec.spec_draft
            if mode == "auto":
                mode = "model" if draft_params is not None else "ngram"
            if mode not in ("model", "ngram"):
                raise ValueError(
                    f"unknown spec_draft {ec.spec_draft!r}; expected "
                    "'model', 'ngram', or 'auto'")
            if mode == "model":
                if draft_params is None or draft_cfg is None:
                    raise ValueError(
                        "spec_draft='model' needs draft_params and "
                        "draft_cfg (a shallower TransformerConfig sharing "
                        "the tokenizer)")
                if draft_cfg.vocab_size != cfg.vocab_size:
                    raise ValueError(
                        f"draft model must share the tokenizer: vocab "
                        f"{draft_cfg.vocab_size} != {cfg.vocab_size}")
            self._spec_model = mode == "model"
        if ec.prefill_chunk_tokens < 0:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1 (or 0 to disable), got "
                f"{ec.prefill_chunk_tokens}")
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
        # Slots whose prompt is still landing chunk by chunk; they hold
        # pages and occupancy but are out of the decode mask.  The
        # per-tick ledger of prompt tokens prefilled (the admission's
        # budget and _advance_ingest share it) and the slots that landed
        # a chunk this tick.
        self._ingest: Dict[int, _IngestState] = {}
        self._tick_prefill_spent = 0
        self._tick_ingested: set = set()
        # Registered shared prefixes (token tuple -> entry).  The
        # version keys each request's cached match; the epoch says which
        # lifetime of the pool an entry's pinned pages belong to.
        self._prefixes: Dict[tuple, _PrefixEntry] = {}
        self._prefix_version = 0
        self._cache_epoch = 0
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
        # The admission path's graphs (whole prompts, suffixes and chunks,
        # the first-token sampler), over the same parameters and pool.
        self._graphs = PrefillGraphs(params, cfg, self.slots.cache,
                                     self.device)
        # Speculative state.  _spec_host is the per-slot opt-out mask
        # (submit(speculative=False), sampled requests, a draft pool too
        # small for the prompt); _spec_live the adaptive mask (False:
        # acceptance fell under the floor), _spec_win the (drafted,
        # accepted) window, _spec_idle the ticks since a disable (a
        # probe re-enables at spec_probe_period), _spec_stale the slots
        # whose draft state missed plain ticks and must be rebuilt
        # before they speculate again.
        self._spec_host = np.ones(ec.n_slots, bool)
        # The online tuner's speculation gate (tuning/params.py
        # "spec_enabled"): False routes new admissions to the plain tick
        # through the opt-out mask, data for both captured ticks.
        self._spec_runtime_enabled = True
        self._spec_live = np.ones(ec.n_slots, bool)
        self._spec_win = np.zeros((ec.n_slots, 2), np.int64)
        self._spec_idle = np.zeros(ec.n_slots, np.int64)
        self._spec_stale = np.zeros(ec.n_slots, bool)
        # The dispatch-time speculation mask last uploaded into the
        # speculative tick, and the draft table's uploaded version.
        self._spec_mask: Optional[np.ndarray] = None
        self._dtable_uploaded = -1
        # The model draft's pool (slot-aligned with the target's, model
        # dtype) and its admission prefills, one graph per (bucket, k);
        # the n-gram draft's history lives in the speculative tick.
        self.draft_slots: Optional[PagedSlotCache] = None
        self._draft_graphs: Optional[PrefillGraphs] = None
        self._spec_tick: Optional[SpecTick] = None
        if self._spec:
            draft = None
            if self._spec_model:
                self.draft_slots = PagedSlotCache(
                    draft_cfg, ec.n_slots, self.slots.max_len,
                    page_size=ec.page_size, n_pages=ec.draft_n_pages,
                    device=self.device)
                self._draft_graphs = PrefillGraphs(
                    draft_params, draft_cfg, self.draft_slots.cache,
                    self.device, draft=True)
                draft = (draft_params, draft_cfg, self.draft_slots.cache)
            self._spec_tick = SpecTick(self._tick, ec.spec_k,
                                       self.slots.max_len, draft)
        # Reserved device memory before and after the last warm sweep.
        self._warm_reserved = (0, 0)
        # The online autotuner (EngineConfig.autotune), installed at the
        # end of warmup(): its knob space is read from the warmed graphs.
        self._tuner = None
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
        # Token-rate window for achieved FLOP/s: (monotonic, tokens)
        # samples taken by stats() and /metrics scrapes, pruned to ~60 s,
        # under a lock of its own (HTTP handler threads read it).
        self._rate_samples: List = []
        self._rate_lock = threading.Lock()
        self._rate_metrics = self.metrics
        if ec.model_flops_per_token:
            self.metrics.model_flops_per_token.set(ec.model_flops_per_token)
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
               trace_id: Optional[str] = None,
               parent_span: Optional[str] = None,
               sampled: bool = False,
               speculative: Optional[bool] = None) -> GenerationFuture:
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
        server passes the ``X-Trace-Id`` header) names the request's
        :class:`~horovod_tpu_torch.obs.tracing.RequestTrace` and keys its
        journal entry; a fresh 16-hex-digit id is minted when absent, and
        the future carries it as ``trace_id`` beside its
        :meth:`~GenerationFuture.breakdown`.  ``parent_span`` nests the
        request's span under an upstream caller's (``X-Parent-Span``)
        and ``sampled`` forces full-detail span retention
        (``X-Trace-Sampled``); both matter only while a
        :func:`~horovod_tpu_torch.obs.tracing.spans` recorder is active,
        which writes the span's start record once the request is
        queued.  ``speculative`` is the
        per-request opt-out on a speculative engine (None = the engine's
        default): ``False`` decodes the request one token a tick, its
        acceptance held at 0 as data — the same tokens, steadier pacing.
        A sampled request never speculates.  Ignored on a plain engine.

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
        fut.trace = obs_tracing.RequestTrace(trace_id,
                                             parent_span_id=parent_span)
        fut.trace.sampled = bool(sampled)
        fut._tracer = obs_tracing.get()
        fut._spans = obs_tracing.spans()
        req = Request(prompt=prompt, max_new_tokens=n_new, future=fut,
                      eos_id=eos_id, deadline=deadline, trace=fut.trace,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed, priority=priority, speculative=speculative)
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
        if fut._spans is not None:
            # The span's start record is written (and flushed) the moment
            # the request is live: a process killed after this leaves
            # the start and every typed event in the stream.
            try:
                fut._spans.request_begin(fut.trace, attrs={
                    "prompt_tokens": len(prompt),
                    "max_new_tokens": n_new,
                    "request_id": req.id})
            except Exception:  # pragma: no cover - spans must not fail work
                pass
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
        # The autotuner, after a clean step and outside the step lock:
        # an apply takes the lock, so it lands between two steps, never
        # inside one step's dispatch-to-fetch sequence.
        if self._tuner is not None:
            try:
                self._tuner.on_tick(self, worked)
            except Exception:  # tuning never takes serving down
                self._tuner = None
        return worked

    def _update_page_gauges(self) -> None:
        self.metrics.kv_pages_free.set(self.slots.free_pages)
        self.metrics.kv_pages_shared.set(self.slots.pages_shared)

    def _release(self, slot: int) -> None:
        """Free a slot and its speculative companions: the draft pool's
        paired slot and the opt-out mask (the engine's default for the
        next tenant).  The adaptive live/idle state survives the
        tenancy, as the JAX engine keeps it: acceptance is a property of
        the workload, and probes still re-enable the slot."""
        self._states[slot] = None
        self._ingest.pop(slot, None)
        self.slots.free(slot)
        self._samp.clear(slot)  # a zero row: greedy, for the next tenant
        self._spec_host[slot] = True
        self._spec_win[slot] = 0
        if (self.draft_slots is not None
                and self.draft_slots._active[slot]):
            self.draft_slots.free(slot)

    def _reclaim_cancelled(self) -> bool:
        """Free slots whose requests were cancelled caller-side (resolved
        with the tokens so far) or resolved elsewhere, ingesting slots
        included."""
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
        for s in list(self._ingest):
            worked = self._reap_ingest(s) or worked
        return worked

    def _reap_ingest(self, slot: int) -> bool:
        """Release an ingesting slot whose request can no longer run (its
        future resolved elsewhere, or a cancel pending); True if it was
        reaped."""
        ing = self._ingest.get(slot)
        if ing is None:
            return False
        fut = ing.request.future
        if not (fut.done() or fut.cancel_requested):
            return False
        if not fut.done():
            fut._finish("cancelled")
            self.metrics.cancelled.inc()
        self._release(slot)
        return True

    def _bucket(self, n: int) -> int:
        b = max(self.engine_cfg.min_prefill_bucket, 1)
        while b < n:
            b *= 2
        return min(b, self.slots.max_len)

    def _resumable(self) -> bool:
        return self.engine_cfg.resume and self.journal is not None

    # -- shared prefixes ---------------------------------------------------

    def register_prefix(self, tokens: Sequence[int]) -> None:
        """Register a shared prefix (a system prompt): its K/V is
        prefilled once into pinned pages, and every later request whose
        prompt starts with it attaches those pages and prefills only its
        suffix; a request whose prompt is the prefix admits with no
        prefill.  The pages stay pinned across slot churn until
        :meth:`unregister_prefix`; a restart invalidates the entry, which
        re-prefills at its next use.  Raises :class:`ServingError` (empty
        or out-of-vocabulary), :class:`RequestTooLongError`, or
        :class:`CacheOutOfPagesError` when the pool cannot pin it; a
        failed registration leaves nothing behind."""
        tokens = tuple(int(t) for t in tokens)
        if not tokens:
            raise ServingError("empty prefix")
        V = self.cfg.vocab_size
        if min(tokens) < 0 or max(tokens) >= V:
            raise ServingError(f"token ids must lie in [0, {V})")
        if len(tokens) > self.slots.max_len:
            raise RequestTooLongError(
                f"prefix ({len(tokens)}) exceeds slot capacity "
                f"({self.slots.max_len})")
        with self._lock:
            fresh = tokens not in self._prefixes
            entry = self._prefixes.setdefault(tokens,
                                              _PrefixEntry(tokens=tokens))
            try:
                self._ensure_prefix(entry)
            except BaseException:
                if fresh:
                    # A failed registration leaves no entry that could
                    # pin pages later for a prefix the caller was told
                    # never registered.
                    self._prefixes.pop(tokens, None)
                raise
            if fresh:
                self._prefix_version += 1

    def unregister_prefix(self, tokens: Sequence[int]) -> None:
        """Drop a registered prefix's pin; its pages return to the free
        heap once the last slot attached to them retires."""
        with self._lock:
            entry = self._prefixes.pop(tuple(int(t) for t in tokens), None)
            if entry is not None:
                self._prefix_version += 1
            if (entry is not None and entry.pages
                    and entry.epoch == self._cache_epoch):
                self.slots.release_raw(entry.pages)

    def _matched_prefix(self, req: Request) -> Optional[_PrefixEntry]:
        """:meth:`_match_prefix` once per request: cached on the request
        and keyed by the registration set's version."""
        cached = getattr(req, "_prefix_match", None)
        if cached is not None and cached[0] == self._prefix_version:
            return cached[1]
        entry = self._match_prefix(req.prompt)
        req._prefix_match = (self._prefix_version, entry)
        return entry

    def _match_prefix(self, prompt) -> Optional[_PrefixEntry]:
        """The longest registered prefix the prompt starts with."""
        best = None
        for entry in self._prefixes.values():
            n = len(entry.tokens)
            if n <= len(prompt) and tuple(prompt[:n]) == entry.tokens:
                if best is None or n > len(best.tokens):
                    best = entry
        return best

    def _landing(self, slots: List[int], lens: np.ndarray, start: int,
                 bucket: int) -> Dict:
        """A prefill graph's landing fields for ``slots`` (positions
        ``start + t``; each slot's position becomes ``start + lens``)."""
        new_pos, phys, off = self.slots.landing(slots, lens, start,
                                                bucket=bucket)
        return dict(slots=slots, new_pos=new_pos, valid=1, phys=phys,
                    off=off)

    def _replay(self, key: tuple, fields: Dict, graphs=None):
        """One prefill through its graph (:class:`~horovod_tpu_torch.
        serving.graph.PrefillGraphs`: a replay on CUDA, the eager body
        on the CPU) -> ``(logits (k, V), argmax (k,), max logit (k,))``,
        its K/V landed.  The outputs hold until the next replay.
        ``graphs``: the target's (None) or the draft model's."""
        graphs = graphs or self._graphs
        g = graphs.get(key)
        g.set(**fields)
        out = graphs.run(g)
        self._prefill_calls += 1
        return out

    def _prefill_rows(self, padded: np.ndarray, lens: np.ndarray,
                      landing: Dict):
        """One batch prefill of right-padded prompts from position 0, its
        ``("full", bucket, k)`` graph (:meth:`_replay`)."""
        k, bucket = padded.shape
        return self._replay(("full", bucket, k),
                            dict(tokens=padded, lens=lens, **landing))

    def _prefill_suffix(self, padded: np.ndarray, lens: np.ndarray, p0: int,
                        pages: List[int], landing: Dict):
        """One batch prefill of right-padded suffixes over the first
        ``p0`` positions held in ``pages``, its ``("suffix", prefix
        pages, bucket, k)`` graph (:meth:`_replay`): the pages go in
        NULL-padded to a power-of-two count (:func:`~horovod_tpu_torch.
        serving.cache.pad_pages`), ``p0`` as data."""
        k, bucket = padded.shape
        pages = pad_pages(pages)
        return self._replay(("suffix", len(pages), bucket, k),
                            dict(tokens=padded, lens=lens, p0=p0,
                                 pages=pages, **landing))

    def _ensure_prefix(self, entry: _PrefixEntry) -> None:
        """(Re-)prefill a prefix entry into pinned pages: the one prefix
        forward pass its sharers amortize, its first greedy token and
        its logits' finiteness fetched in one sync.  Raises
        :class:`CacheOutOfPagesError` when the pool cannot pin it; any
        failure unpins the pages."""
        if entry.pages is not None and entry.epoch == self._cache_epoch:
            return
        p0 = len(entry.tokens)
        pages = self.slots.grant_raw(self.slots.pages_for(p0))
        try:
            bucket = self._bucket(p0)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :p0] = entry.tokens
            phys, off = self.slots.landing_raw(pages, p0, bucket=bucket)
            logits, first, mx = self._prefill_rows(
                padded, np.array([p0], np.int64),
                dict(slots=0, new_pos=0, valid=0, phys=phys, off=off))
            kept = logits[0].clone()  # before any other replay
            first, mx = download(first, mx).wait()
            self.metrics.host_syncs.inc()
            if not np.isfinite(mx).all():
                raise EngineFailedError(
                    "non-finite logits from the prefix prefill (bad params "
                    "or device fault)")
            entry.first_token = int(first[0])
            entry.logits = kept
        except BaseException:
            # Unpinned on any failure, or every retry would drain the
            # pool a little further.
            self.slots.release_raw(pages)
            raise
        entry.pages = pages
        entry.epoch = self._cache_epoch

    def _prefix_landed(self, req: Request) -> int:
        """Prompt tokens a matched prefix of the current epoch already
        holds for this request (0 without one)."""
        entry = self._matched_prefix(req)
        if (entry is not None and entry.pages is not None
                and entry.epoch == self._cache_epoch):
            return len(entry.tokens)
        return 0

    def _chunked(self, req: Request) -> bool:
        """True when chunking is on and the prompt tokens that need a
        prefill (past a matched prefix) exceed one chunk."""
        chunk = self.engine_cfg.prefill_chunk_tokens
        return bool(chunk) and (len(req.prompt)
                                - self._prefix_landed(req)) > chunk

    def _prefill_cost(self, req: Request) -> int:
        """Prompt tokens admitting ``req`` costs this tick: its unshared
        part, at most one chunk when chunking is on."""
        suf = len(req.prompt) - self._prefix_landed(req)
        chunk = self.engine_cfg.prefill_chunk_tokens
        return min(suf, chunk) if chunk else suf

    def _plan_pages(self, req: Request) -> int:
        """Pages an admission would take (private grants plus one page
        of margin for a copy-on-write or decode growth): the take's
        back-pressure budget.  Attached prefix pages cost nothing; a
        chunked admission plans its first chunk only (later chunks
        claim their pages at their tick, preempting like decode growth
        does)."""
        ps = self.slots.page_size
        p0 = self._prefix_landed(req)
        upto = len(req.prompt)
        if self._chunked(req):
            upto = p0 + self.engine_cfg.prefill_chunk_tokens
        n_idx = (upto - 1) // ps + 1
        if p0 > 0:
            if len(req.prompt) == p0:
                return 1  # attach-only: the margin covers the first COW
            return n_idx - p0 // ps + 1
        return n_idx + 1

    def _group_key(self, req: Request):
        """The take's admission-group key: one prefill serves the group,
        so the key is the prompt bucket (``full``), or the matched prefix
        and the suffix's bucket (``suffix``: one gather of the prefix and
        one suffix prefill), or the prefix alone (``attach``: no
        prefill).  A chunked request is taken alone (``chunk``)."""
        if self._chunked(req):
            return ("chunk", req.id)
        entry = self._matched_prefix(req)
        if entry is None:
            return ("full", self._bucket(len(req.prompt)))
        suf = len(req.prompt) - len(entry.tokens)
        if suf == 0:
            return ("attach", entry.tokens)
        return ("suffix", entry.tokens, self._bucket(suf))

    # -- admission ---------------------------------------------------------

    def _admit_pending(self) -> bool:
        # Tick-boundary sweep: every dead queued request (lapsed
        # deadline, cancel, raced drain) resolves wherever it sits.
        swept = self.scheduler.sweep()
        self._tick_prefill_spent = 0
        self._tick_ingested = set()
        # Slot pressure before the take: a strictly better-class arrival
        # claims a slot from the worst occupant (suspended, not lost).
        preempted = self._preempt_for_slots()
        # Page back-pressure: the take stops (requests wait, order kept)
        # when the next admission's planned pages would overdraw the
        # free heap.  The plan is clamped to the deepest the heap can
        # get (the pool less the registry's pins), or a request that fit
        # at submit would wait at the head forever.
        budget = self.slots.free_pages
        pinned = sum(len(e.pages) for e in self._prefixes.values()
                     if e.pages is not None
                     and e.epoch == self._cache_epoch)
        attainable = max(self.slots.n_pages - pinned, 1)
        reserved = 0
        # The per-tick prefill token budget (chunked prefill): admissions
        # after the first stop once the tick's budget is spent.  The
        # first is always let in: a chunked one costs at most a chunk,
        # and a short prompt over the budget must not wait forever.
        tok_budget = self.engine_cfg.prefill_chunk_tokens
        n_admit = 0

        def admit_fn(req):
            nonlocal reserved, n_admit
            need = min(self._plan_pages(req), attainable)
            if reserved + need > budget:
                return False
            if tok_budget:
                cost = self._prefill_cost(req)
                if n_admit and self._tick_prefill_spent + cost > tok_budget:
                    return False
                if not self._chunked(req):
                    # A chunked admission's chunk is counted where it
                    # lands (_ingest_step).
                    self._tick_prefill_spent += cost
            reserved += need
            n_admit += 1
            return True

        reqs = self.scheduler.take(self.slots.free_count,
                                   bucket_fn=self._group_key,
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
        advanced = self._advance_ingest()
        return bool(reqs) or advanced or bool(swept) or preempted

    def _observe_admission(self, req: Request, now: float) -> None:
        """Queue wait ends at a request's first admission; a resumed or
        preempted re-admission keeps its first life's."""
        if req.trace.admitted_at is None:
            req.trace.admitted_at = now
            self.metrics.observe_queue_wait(req.priority,
                                            now - req.submitted_at)

    def _admit_batch(self, reqs: List[Request]) -> None:
        """Admit one group (:meth:`_group_key`): map its pages, run its
        one prefill (whole prompts, or suffixes over a shared prefix, or
        none when the prompt is the prefix), land the K/V and emit each
        first token.  A chunked request is taken alone and ingested
        chunk by chunk instead (:meth:`_admit_chunked`).  A resumed
        request's prompt is its original prompt plus the tokens it
        emitted before, so the same prefill continues its stream."""
        if len(reqs) == 1 and self._chunked(reqs[0]):
            self._admit_chunked(reqs[0])
            return
        faults = self.engine_cfg.faults
        if faults is not None:
            faults.probe("prefill")
        t_adm = time.monotonic()
        for req in reqs:
            self._observe_admission(req, t_adm)
        slots, live, firsts, synced = self._admit_paged(reqs)
        if not live:
            return
        if synced:
            # Attach-only greedy groups fetch nothing.
            self.metrics.host_syncs.inc()
        now = time.monotonic()
        for slot, req, first in zip(slots, live, firsts):
            self.metrics.admitted.inc()
            self._taken.remove(req)  # landed: _states owns it now
            self._start_decoding(slot, req, int(first), now)
        self._land_first_tokens(slots, firsts)

    def _map_pages(self, slot: int, req: Request,
                   entry: Optional[_PrefixEntry]) -> None:
        """A slot's page table for admission: attach the shared prefix's
        pages, copy-on-write its partial last page if the suffix lands
        in it, grant fresh pages for the rest of the prompt."""
        ps = self.slots.page_size
        n_idx = (len(req.prompt) - 1) // ps + 1
        if entry is None:
            for idx in range(n_idx):
                self.slots.grant(slot, idx)
            return
        p0 = len(entry.tokens)
        self.slots.attach(slot, entry.pages)
        if len(req.prompt) == p0:
            return  # attach-only; decode growth claims its write page
        first_new = p0 // ps
        if p0 % ps:
            self.slots.cow(slot, first_new)
            first_new += 1
        for idx in range(first_new, n_idx):
            self.slots.grant(slot, idx)

    def _admit_paged(self, reqs: List[Request]):
        """The group's pages and its one prefill -> ``(slots, requests,
        first tokens, synced)``.  The group shares one matched prefix
        (or none) and one bucket: the prompt is the prefix (attach, no
        prefill: greedy rows take the prefix's first token with no
        sync, sampled rows draw from its logits at key position
        ``len(prompt)``), or one suffix prefill attends the prefix's
        gathered pages, or one whole-prompt prefill.  A request whose
        pages overdraw the pool (the budget is a plan, not a
        reservation) fails with :class:`CacheOutOfPagesError` and the
        rest of the group proceeds."""
        entry = self._matched_prefix(reqs[0])
        if entry is not None:
            try:
                self._ensure_prefix(entry)
            except CacheOutOfPagesError:
                entry = None  # no sharing: a whole-prompt prefill
        p0 = len(entry.tokens) if entry is not None else 0
        slots: List[int] = []
        live: List[Request] = []
        for req in reqs:
            slot = self.slots.alloc()
            assert slot is not None  # take() is bounded by free_count
            try:
                self._map_pages(slot, req, entry)
            except CacheOutOfPagesError as e:
                self._release(slot)  # returns whatever got mapped
                req.future.set_exception(e)
                self.metrics.rejected.inc()
                self._taken.remove(req)
                continue
            slots.append(slot)
            live.append(req)
        if not live:
            return [], [], [], False
        k = len(live)
        synced = True
        if entry is not None and all(len(r.prompt) == p0 for r in live):
            self.slots.set_pos(slots, [p0] * k)
            if any(r.temperature > 0.0 for r in live):
                firsts = self._first_tokens(
                    live, entry.logits[None].expand(k, -1))
            else:
                firsts = [entry.first_token] * k
                synced = False
        elif entry is not None:
            suf_lens = np.array([len(r.prompt) - p0 for r in live],
                                np.int64)
            padded = np.zeros((k, self._bucket(int(suf_lens.max()))),
                              np.int64)
            for i, r in enumerate(live):
                padded[i, :suf_lens[i]] = r.prompt[p0:]
            out = self._prefill_suffix(
                padded, suf_lens, p0, entry.pages,
                self._landing(slots, suf_lens, p0, padded.shape[1]))
            firsts = self._first_tokens(live, *out)
        else:
            lens = np.array([len(r.prompt) for r in live], np.int64)
            padded = np.zeros((k, max(self._bucket(n) for n in lens)),
                              np.int64)
            for i, r in enumerate(live):
                padded[i, :lens[i]] = r.prompt
            out = self._prefill_rows(
                padded, lens, self._landing(slots, lens, 0, padded.shape[1]))
            firsts = self._first_tokens(live, *out)  # one sync for K
        # Before the first tokens are emitted: one may retire its request
        # and free the slot, and a draft slot acquired after that would
        # have no owner.
        self._spec_admit(slots, live)
        return slots, live, firsts, synced

    def _start_decoding(self, slot: int, req: Request, first: int,
                        now: float) -> None:
        """A landed prompt's first token: TTFT (a resumed request served
        its first token in an earlier life; that TTFT stands), the
        slot's sampling columns (they land before the next dispatch; a
        greedy request writes the zero row), the slot's state and write
        position, then the token itself."""
        if req.future.ttft is None:
            req.future.ttft = now - req.submitted_at
            self.metrics.observe_ttft(req.priority, req.future.ttft)
        if req.trace is not None:
            req.trace.slot = slot
            if req.trace.first_token_at is None:
                # A resumed request keeps its first life's stamp.
                req.trace.first_token_at = now
        self._samp.set(slot, temperature=req.temperature, top_k=req.top_k,
                       top_p=req.top_p, seed=req.seed)
        self._states[slot] = _SlotState(request=req, last_token=first,
                                        n_generated=0)
        self._page_pos[slot] = len(req.prompt)
        self._emit(slot, first)

    def _land_first_tokens(self, slots: List[int], firsts) -> None:
        """First tokens into the device token vector of a live pipeline
        (a slot that its first token retired is inactive: a don't-care)."""
        if not self._tokens_live:
            return
        dev = self.device
        vals = np.zeros(self.engine_cfg.n_slots, np.int64)
        mask = np.zeros(self.engine_cfg.n_slots, bool)
        vals[slots] = firsts
        mask[slots] = True
        tok = self._tick.tokens
        tok.copy_(torch.where(upload(mask, dev), upload(vals, dev), tok))

    def _first_tokens(self, reqs: List[Request], logits, picks=None,
                      max_logit=None) -> List[int]:
        """An admission group's first tokens from its prefill (the
        prefill is the first decode step): for an all-greedy group the
        prefill graph's argmax ``picks``, else the ``("sample", k)``
        graph over ``logits`` (:func:`~horovod_tpu_torch.models.
        transformer.sample_token_rows`, each row's own parameters at key
        position ``len(prompt)``; greedy rows still take the argmax).

        The logits get the decode tick's finiteness check (each row's
        max logit), fetched in the same host sync as the tokens: a
        non-finite row raises :class:`EngineFailedError` before any of
        the group's tokens is emitted.  (The JAX engine does not check
        prefill logits and emits the argmax of NaN.)"""
        if picks is None or any(r.temperature > 0.0 for r in reqs):
            picks, max_logit = self._sample_first(reqs, logits)
        toks, mx = download(picks, max_logit).wait()
        if not np.isfinite(mx).all():
            raise EngineFailedError(
                "non-finite logits from prefill (bad params or device "
                "fault)")
        return toks.tolist()

    def _sample_first(self, reqs: List[Request], logits):
        """The first-token sampler's graph for the group: ``logits``
        copied into its input, each row's sampling columns uploaded ->
        ``(tokens, max logit)``."""
        g = self._graphs.get(("sample", len(reqs)))
        g.logits.copy_(logits)
        g.set(temp=[r.temperature for r in reqs],
              top_k=[r.top_k for r in reqs],
              top_p=[r.top_p for r in reqs],
              keys=np.stack([seed_key(r.seed) for r in reqs]),
              pos=[len(r.prompt) for r in reqs])
        return self._graphs.run(g)

    # -- chunked prefill ---------------------------------------------------

    def _decode_mask(self) -> np.ndarray:
        """The tick's active mask: allocated slots less those still
        ingesting (they hold pages but have no token to decode yet)."""
        active = self.slots.active_mask()
        for s in self._ingest:
            active[s] = False
        return active

    def _admit_chunked(self, req: Request) -> None:
        """Admit one long prompt for chunked ingestion: attach a matched
        prefix (a refcount, no compute), open its ingest state and land
        the first chunk on this tick's budget.  The slot decodes nothing
        until its last chunk yields the first token
        (:meth:`_finish_ingest`)."""
        self._observe_admission(req, time.monotonic())
        entry = self._matched_prefix(req)
        if entry is not None:
            try:
                self._ensure_prefix(entry)
            except CacheOutOfPagesError:
                entry = None  # no sharing: chunk the whole prompt
        slot = self.slots.alloc()
        assert slot is not None  # take() is bounded by free_count
        p0 = 0
        if entry is not None:
            self.slots.attach(slot, entry.pages)
            p0 = len(entry.tokens)
        self._ingest[slot] = _IngestState(request=req, landed=p0,
                                          started=p0)
        self._page_pos[slot] = p0
        self.metrics.admitted.inc()
        self._taken.remove(req)  # the ingest state owns it now
        self._ingest_step(slot)

    def _ensure_ingest_pages(self, slot: int, lo: int, hi: int) -> bool:
        """Private pages under positions ``[lo, hi]`` for a chunk
        (:meth:`_claim_page`: a copy-on-write of an attached prefix's
        partial last page, grants for the rest); False if ``slot``
        itself was preempted paying for them."""
        ps = self.slots.page_size
        for idx in range(lo // ps, hi // ps + 1):
            if not self._claim_page(slot, idx,
                                    lambda: slot in self._ingest):
                return False
        return True

    def _landed_pages(self, slot: int, lo: int) -> List[int]:
        """The pages holding the slot's first ``lo`` landed positions:
        the prefix of its next chunk (:meth:`_prefill_suffix` pads their
        count to a power of two, as the JAX ``_gather_landed`` does)."""
        return self.slots.table[slot, :self.slots.pages_for(lo)].tolist()

    def _ingest_step(self, slot: int) -> bool:
        """Land one chunk of ``slot``'s prompt: claim its pages, run it
        through ``prefill_with_prefix`` over the landed positions (the
        first chunk, with nothing landed, through the plain prefill),
        landing its K/V in the slot's pages in the same graph.  Only the
        last chunk fetches anything: :meth:`_finish_ingest` turns its
        outputs into the first token.  True if any work was done."""
        ing = self._ingest.get(slot)
        if ing is None:
            return False
        if self._reap_ingest(slot):
            return True
        req = ing.request
        if req.deadline is not None and time.monotonic() > req.deadline:
            # The caller is gone: retire with whatever an earlier life
            # emitted rather than finish an ingestion nobody reads.
            req.future._finish("deadline")
            self.metrics.completed.inc()
            self._release(slot)
            return True
        faults = self.engine_cfg.faults
        if faults is not None:
            faults.probe("prefill_chunk")
        chunk = self.engine_cfg.prefill_chunk_tokens
        lo = ing.landed
        n = min(len(req.prompt) - lo, chunk)
        if not self._ensure_ingest_pages(slot, lo, lo + n - 1):
            return True  # preempted paying for its own chunk
        # One bucket for every chunk: the tail chunk is right-padded.
        padded = np.zeros((1, self._bucket(chunk)), np.int64)
        padded[0, :n] = req.prompt[lo:lo + n]
        lens = np.array([n], np.int64)
        landing = self._landing([slot], lens, lo, padded.shape[1])
        if lo == 0:
            out = self._prefill_rows(padded, lens, landing)
        else:
            out = self._prefill_suffix(padded, lens, lo,
                                       self._landed_pages(slot, lo), landing)
        self._tick_prefill_spent += n
        self._tick_ingested.add(slot)
        ing.landed = lo + n
        self._page_pos[slot] = ing.landed
        if ing.landed >= len(req.prompt):
            self._finish_ingest(slot, ing, out)
        return True

    def _finish_ingest(self, slot: int, ing: _IngestState, out) -> None:
        """The last chunk landed: its graph's outputs (logits, argmax,
        max logit) are the whole prompt's last position's, so the first
        token (the argmax, or the draw at key position ``len(prompt)``)
        is a whole-prompt admission's, and the slot joins the decode
        mask."""
        req = ing.request
        del self._ingest[slot]
        first = int(self._first_tokens([req], *out)[0])
        self.metrics.host_syncs.inc()
        if self._spec_model:
            # A model draft would prefill the whole long prompt in one
            # tick, the stall chunking removes: the slot decodes plain
            # (the same tokens).  The n-gram draft lands its history.
            self._spec_host[slot] = False
        else:
            self._spec_admit([slot], [req])
        self._start_decoding(slot, req, first, time.monotonic())
        self._land_first_tokens([slot], [first])

    def _advance_ingest(self) -> bool:
        """Advance ingestions with this tick's remaining prefill budget,
        oldest request first, a chunk each.  The oldest advances even
        when admissions spent the budget (so equal or worse classes
        cannot starve it), unless a strictly better class waits for the
        next tick's budget; a tick's prefill stays within twice the
        budget."""
        chunk = self.engine_cfg.prefill_chunk_tokens
        worked = False
        oldest = True
        for slot in sorted(self._ingest,
                           key=lambda s: self._ingest[s].request.id):
            ing = self._ingest.get(slot)
            if ing is None:
                continue  # preempted by an earlier chunk's page claim
            if self._tick_prefill_spent >= chunk:
                if not oldest or slot in self._tick_ingested:
                    break
                best = self.scheduler.peek_best_rank()
                if best is not None and best < ing.request.priority_rank:
                    break
            worked = self._ingest_step(slot) or worked
            oldest = False
        return worked

    # -- preemption --------------------------------------------------------

    def _occupants(self) -> List:
        """Every occupied slot, decoding or ingesting, as ``(priority
        rank, request id, slot, request)``: ``max()`` of the list is the
        preemption victim, the worst class and the youngest request
        within it."""
        occ = [(st.request.priority_rank, st.request.id, s, st.request)
               for s, st in enumerate(self._states) if st is not None]
        occ += [(ing.request.priority_rank, ing.request.id, s, ing.request)
                for s, ing in self._ingest.items()]
        return occ
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
                      priority=req.priority, speculative=req.speculative)
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
        st, ing = self._states[slot], self._ingest.get(slot)
        if st is None and ing is None:
            return False
        req = st.request if st is not None else ing.request
        fut = req.future
        # The submit-time recorder (not the global): the span's start
        # and finish go through it, so its events must too.
        srec = fut._spans
        if srec is not None and req.trace is not None:
            try:
                srec.request_event(req.trace, "eviction",
                                   {"slot": slot, "reason": reason})
            except Exception:  # pragma: no cover - spans must not fail work
                pass
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
        if ing is not None:
            # A victim mid-ingestion emitted nothing, but its landed
            # chunks were prefill that the re-ingestion repeats.
            new._resume_wasted = max(new._resume_wasted,
                                     ing.landed - ing.started)
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

    def _claim_page(self, slot: int, idx: int, still_mine) -> bool:
        """The one grant / copy-on-write / evict protocol (decode growth
        and chunk ingestion both use it): make ``slot`` own a private
        page at table index ``idx`` — granted when unmapped, copied when
        shared, left alone when already private — preempting victims
        while the pool is exhausted.  ``still_mine()`` is the caller's
        occupancy check; False when ``slot`` itself was the victim."""
        while True:
            try:
                if self.slots.table[slot, idx] == NULL_PAGE:
                    self.slots.grant(slot, idx)
                else:
                    self.slots.cow(slot, idx)
                return True
            except CacheOutOfPagesError:
                self._evict_for_pages()
                if not still_mine():
                    return False

    # -- speculative decoding ----------------------------------------------

    def _ensure_write_range(self, s: int, lo: int, hi: int) -> bool:
        """Private pages under every write position in ``[lo, hi]`` (one
        position for the plain tick, a window for the speculative one),
        through :meth:`_claim_page`.  Positions past the request's last real
        write or the table are left unmapped: the verify routes those
        writes to the NULL page.  False if slot ``s`` itself was
        preempted paying for them."""
        st = self._states[s]
        if st is None:
            return False
        last_real = len(st.request.prompt) + st.request.max_new_tokens - 2
        hi = min(hi, last_real, self.slots.max_len - 1)
        if hi < lo:
            return True
        ps = self.slots.page_size
        for idx in range(max(lo, 0) // ps, hi // ps + 1):
            if not self._claim_page(s, idx,
                                    lambda: self._states[s] is not None):
                return False
        return True

    def _ensure_draft_range(self, s: int, lo: int, hi: int) -> None:
        """The draft pool's pages under ``[lo, hi]``.  Draft pages never
        preempt anyone: on exhaustion the slot stops speculating (its
        acceptance held at 0 as data) and its draft pages return to the
        heap; the tokens never depend on the draft."""
        draft = self.draft_slots
        st = self._states[s]
        if (st is None or not self._spec_host[s] or not self._spec_live[s]
                or not draft._active[s]):
            return
        last_real = len(st.request.prompt) + st.request.max_new_tokens - 2
        hi = min(hi, last_real, draft.max_len - 1)
        ps = draft.page_size
        try:
            for idx in range(max(lo, 0) // ps, hi // ps + 1):
                if draft.table[s, idx] == NULL_PAGE:
                    draft.grant(s, idx)
        except CacheOutOfPagesError:
            draft.free(s)
            self._spec_host[s] = False

    def _prepare_tick(self) -> None:
        """Tick-boundary page maintenance: every decoding slot gets
        private pages under the positions the next tick writes (granted,
        or copied from a shared one; preempting on exhaustion), then the
        tick's tables and the speculation mask are refreshed iff they
        changed.

        The plain tick writes one position, ``_page_pos`` (the
        dispatch-time mirror).  The speculative tick writes a window,
        ``[pos, pos + spec_k]``, and with the overlapped pipeline the
        tick in flight may already have advanced the device position by
        up to ``spec_k + 1`` (the host learns the accepted length one
        tick late, so ``_page_pos`` is the fetch-time mirror there): its
        grants cover that worst case, ``2W - 1`` positions, in the draft
        pool too.  Over-granted pages are used within a few ticks or
        freed at retirement."""
        W = self.engine_cfg.spec_k + 1
        pend = self._pending
        for s in range(self.engine_cfg.n_slots):
            st = self._states[s]
            if st is None:
                continue
            base = hi = int(self._page_pos[s])
            if self._spec:
                inflight = (pend is not None and bool(pend["active"][s])
                            and pend["reqs"][s] is st.request)
                hi = base + (2 if inflight else 1) * W - 1
            else:
                # page_grant_ahead widens the plain tick's one position
                # by that many pages (capped at the last real write).
                hi = base + self.engine_cfg.page_grant_ahead \
                    * self.slots.page_size
            if self._ensure_write_range(s, base, hi) and self._spec_model:
                self._ensure_draft_range(s, base, hi)
        if self._table_uploaded != self.slots.table_version:
            upload_into(self._tick.table, self.slots.table)
            self._table_uploaded = self.slots.table_version
        if not self._spec:
            return
        if (self._spec_model
                and self._dtable_uploaded != self.draft_slots.table_version):
            upload_into(self._spec_tick.dtable, self.draft_slots.table)
            self._dtable_uploaded = self.draft_slots.table_version
        spec = self._spec_host & self._spec_live & self._decode_mask()
        if self._spec_mask is None or not np.array_equal(spec,
                                                         self._spec_mask):
            upload_into(self._spec_tick.spec_on, spec)
            self._spec_mask = spec

    def _land_history(self, slots: List[int], rows: np.ndarray) -> None:
        """Full-width rows (``max_len + 1``, the trash column 0) into the
        n-gram draft's history: a previous tenant's tokens past the
        prompt must not survive into this request's drafts."""
        dev = self.device
        self._spec_tick.hist.index_copy_(
            0, upload(np.asarray(slots, np.int64), dev), upload(rows, dev))

    def _draft_prefill(self, slots: List[int], padded: np.ndarray,
                       lens: np.ndarray) -> None:
        """Prefill the draft model's pool for ``slots`` with right-padded
        prompts, one replay of its ``("full", bucket, k)`` graph; its
        logits are never fetched (no host sync)."""
        new_pos, phys, off = self.draft_slots.landing(
            slots, lens, 0, bucket=padded.shape[1])
        self._replay(("full", padded.shape[1], len(slots)),
                     dict(tokens=padded, lens=lens, slots=slots,
                          new_pos=new_pos, valid=1, phys=phys, off=off),
                     graphs=self._draft_graphs)

    def _spec_admit(self, slots: List[int], reqs: List[Request]) -> None:
        """An admission's speculative bookkeeping: the per-request
        opt-out into the slot mask (a sampled request never speculates:
        drafts are verified by argmax agreement); the n-gram draft lands
        the prompts in its history; the model draft prefills its own
        pool with the whole prompts (it has no prefix registry), one
        prefill for the group.  A draft pool that cannot hold a prompt
        disables speculation for the slot, never the request."""
        if not self._spec:
            return
        for slot, req in zip(slots, reqs):
            self._spec_host[slot] = (req.speculative is not False
                                     and req.temperature <= 0.0
                                     and self._spec_runtime_enabled)
        if not self._spec_model:
            rows = np.zeros((len(slots), self.slots.max_len + 1), np.int64)
            for i, r in enumerate(reqs):
                rows[i, :len(r.prompt)] = r.prompt
            self._land_history(slots, rows)
            self._spec_stale[slots] = False
            return
        draft = self.draft_slots
        for slot, req in zip(slots, reqs):
            if not self._spec_host[slot]:
                continue
            if not self._spec_live[slot]:
                # Adaptively disabled: a probe rebuilds the draft state
                # from prompt + emitted if it re-enables the slot.
                self._spec_stale[slot] = True
                continue
            draft.acquire(slot)
            try:
                for idx in range(draft.pages_for(len(req.prompt))):
                    draft.grant(slot, idx)
            except CacheOutOfPagesError:
                draft.free(slot)
                self._spec_host[slot] = False
        live = [(s, r) for s, r in zip(slots, reqs)
                if self._spec_host[s] and draft._active[s]]
        if not live:
            return
        bucket = self._bucket(max(len(r.prompt) for _, r in live))
        padded = np.zeros((len(live), bucket), np.int64)
        lens = np.zeros(len(live), np.int64)
        for i, (_, r) in enumerate(live):
            padded[i, :len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt)
        self._draft_prefill([s for s, _ in live], padded, lens)
        for s, _ in live:
            self._spec_stale[s] = False

    def _reset_spec_state(self) -> None:
        """Every slot's speculative state back to the default (opt-out
        mask, adaptive live / idle / window, staleness): the restart,
        terminal and post-warmup paths."""
        self._spec_host[:] = True
        self._spec_live[:] = True
        self._spec_win[:] = 0
        self._spec_idle[:] = 0
        self._spec_stale[:] = False

    def _spec_adapt(self, s: int, accepted: int) -> None:
        """Window the slot's acceptance; disable its speculation when the
        rate falls under ``spec_min_acceptance`` (``spec_adaptive``).
        Pure data: the tokens are the same either way, the slot just
        stops paying for drafts the target rejects."""
        ec = self.engine_cfg
        if not ec.spec_adaptive:
            return
        self._spec_win[s, 0] += ec.spec_k
        self._spec_win[s, 1] += accepted
        if self._spec_win[s, 0] >= ec.spec_window * ec.spec_k:
            rate = self._spec_win[s, 1] / self._spec_win[s, 0]
            if rate < ec.spec_min_acceptance:
                self._spec_live[s] = False
                self._spec_idle[s] = 0
                st = self._states[s]
                srec = st.request.future._spans if st is not None else None
                if srec is not None and st.request.trace is not None:
                    try:
                        srec.request_event(
                            st.request.trace, "spec_fallback",
                            {"slot": s, "acceptance": round(rate, 4)})
                    except Exception:  # pragma: no cover
                        pass
                if self._spec_model:
                    # A disabled slot's draft pool decays even through
                    # speculative ticks (no pages are granted for it), so
                    # the probe must rebuild it; the n-gram history stays
                    # current through them.
                    self._spec_stale[s] = True
            self._spec_win[s] = 0

    def _spec_probe_clock(self, s: int) -> None:
        """A disabled slot's probe clock: at ``spec_probe_period`` ticks
        re-enable speculation for one evaluation window (its draft state
        rebuilt first if plain ticks staled it), so a stream that becomes
        predictable gets speculation back."""
        if not self._spec_live[s] and self._spec_host[s]:
            self._spec_idle[s] += 1
            if self._spec_idle[s] >= self.engine_cfg.spec_probe_period:
                if self._spec_stale[s] and not self._respec_slot(s):
                    self._spec_idle[s] = 0  # rebuild failed: later
                    return
                self._spec_stale[s] = False
                self._spec_live[s] = True
                self._spec_idle[s] = 0
                self._spec_win[s] = 0

    def _respec_slot(self, s: int) -> bool:
        """Rebuild slot ``s``'s draft state from its committed stream,
        ``prompt + tokens emitted this tenancy``: re-land its n-gram
        history row, or re-prefill its draft pool, as admission does.
        Full-width shapes only (a ``(1, max_len)`` draft prefill, warmed
        by :meth:`warmup`), so a probe never meets a shape no warmup
        captured.  The speculative tick's entry copy of the target's
        position covers a tick in flight."""
        st = self._states[s]
        if st is None:
            return False
        toks = st.request.future.tokens_so_far()
        gen = toks[len(toks) - st.n_generated:] if st.n_generated else []
        committed = list(st.request.prompt) + [int(t) for t in gen]
        if not self._spec_model:
            rows = np.zeros((1, self.slots.max_len + 1), np.int64)
            rows[0, :len(committed)] = committed
            self._land_history([s], rows)
            return True
        draft = self.draft_slots
        if not committed:
            return False
        if not draft._active[s]:
            draft.acquire(s)
        try:
            for idx in range(draft.pages_for(len(committed))):
                if draft.table[s, idx] == NULL_PAGE:
                    draft.grant(s, idx)
        except CacheOutOfPagesError:
            draft.free(s)
            return False
        padded = np.zeros((1, self.slots.max_len), np.int64)
        padded[0, :len(committed)] = committed
        self._draft_prefill([s], padded, np.array([len(committed)], np.int64))
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
        """Refresh the tick's mask (iff it changed; ``active`` is
        :meth:`_decode_mask`, so ingesting slots stay out) and sampling
        columns (iff dirty), run one tick over all slots, and start
        fetching its results: the plain tick's next tokens and per-slot
        max logit, or the speculative tick's window ``t`` (S, W), max
        logits (S, W) and accepted lengths (S,).  A speculative engine
        runs the plain tick when no slot speculates.  Returns the pending
        record :meth:`_retire_pending` applies."""
        if (self._active_uploaded is None
                or not np.array_equal(active, self._active_uploaded)):
            upload_into(self._tick.active, active)
            self._active_uploaded = active
        self._samp.device()
        faults = self.engine_cfg.faults
        kind = faults.probe("decode_tick") if faults is not None else None
        extra = {}
        if self._spec and self._spec_mask.any():
            fetch = download(*self._spec_tick.run())
            extra["spec"] = self._spec_mask.copy()
        else:
            if self._spec:
                # Nobody speculates: the plain tick gives the same tokens
                # at plain cost.  The draft state of the slots it runs goes
                # stale, to be rebuilt at a probe.
                self._spec_stale |= self.slots.active_mask()
            fetch = download(*self._tick.run())
            if not self._spec:
                # A speculative engine's mirror advances at fetch, where
                # the host learns how far each slot went.
                self._page_pos += active
        self.metrics.decode_ticks.inc()
        dt = time.monotonic() - t0
        self.metrics.tick_dispatch.observe(dt)
        tp = obs_tracing.get()
        if tp is not None:
            tp.tick_phase("tick_dispatch", t0, dt)
        return {"fetch": fetch, "active": active, "dispatched_at": t0,
                "kind": kind, **extra,
                "reqs": [st.request if st is not None else None
                         for st in self._states]}


    def _decode_tick(self) -> bool:
        """The synchronous tick (``overlap=False``, the A/B baseline):
        upload the tokens, dispatch, fetch and emit in the same step."""
        if self.slots.active_count:
            self._prepare_tick()
        active = self._decode_mask()
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
            self._prepare_tick()
        active = self._decode_mask()
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
        always matches.

        A speculative tick emits ``acc + 1`` tokens a slot, ``t[s,
        0..acc]``, and the host mirror of the slot's position advances by
        as many (the device committed them whatever the host emits); an
        EOS, the length or a deadline inside the accepted run retires the
        slot and drops the rest, as the one-token oracle would never
        emit it.  Acceptance feeds the adaptive control."""
        faults = self.engine_cfg.faults
        if faults is not None:
            faults.probe("decode_fetch")
        t0 = time.monotonic()
        nxt, mx, *rest = p["fetch"].wait()
        acc = rest[0] if rest else None
        self.metrics.host_syncs.inc()
        t1 = time.monotonic()
        self.metrics.tick_device_wait.observe(t1 - t0)
        active = p["active"]
        if p["kind"] == "nonfinite":
            # Injected: NaN logits, applied to the fetched host copy
            # (never inside the captured graph).
            mx = np.where(active if mx.ndim == 1 else active[:, None],
                          np.nan, mx)
        if not np.isfinite(mx[active]).all():
            raise EngineFailedError(
                "non-finite logits from decode tick (bad params or device "
                "fault)")
        lat = t1 - p["dispatched_at"]
        spec_k = self.engine_cfg.spec_k
        for s in np.nonzero(active)[0]:
            s = int(s)
            st = self._states[s]
            if st is None or st.request is not p["reqs"][s]:
                continue  # retired or re-admitted since dispatch: stale
            self.metrics.token_latency.observe(lat)
            tr = st.request.trace
            # Tick detail is buffered only while the request's submit-time
            # recorder is live (one attribute read a slot); whether it
            # leaves the process is the tail-sampling verdict.
            srec = st.request.future._spans if tr is not None else None
            if tr is not None:
                tr.decode_ticks += 1
                # Dispatch to fetch of the tick that produced this token:
                # the overlapped pipeline's one-tick lag, in the breakdown.
                tr.host_sync_lag = lat
            if acc is None:
                self.metrics.tokens_per_tick.observe(1)
                if srec is not None:
                    if len(tr.ticks) < tr.MAX_TICKS:
                        tr.ticks.append((p["dispatched_at"], t1, 1))
                    else:
                        tr.ticks_overflow += 1
                if self._spec:
                    # A plain tick of a speculative engine: one position,
                    # and the disabled slot's probe clock runs.
                    self._page_pos[s] += 1
                    self._spec_probe_clock(s)
                self._emit(s, int(nxt[s]))
                continue
            n = int(acc[s]) + 1
            self._page_pos[s] += n
            if p["spec"][s]:
                self.metrics.spec_drafted.inc(spec_k)
                self.metrics.spec_accepted.inc(int(acc[s]))
                self.metrics.spec_wasted.inc(spec_k - int(acc[s]))
                self.metrics.spec_acceptance.observe(int(acc[s]) / spec_k)
                self._spec_adapt(s, int(acc[s]))
            elif self._spec_host[s] and not self._spec_live[s]:
                # Disabled while others speculate: the n-gram history
                # stays current, the model draft was marked stale at the
                # disable; only the probe clock moves.
                self._spec_probe_clock(s)
            # The detail entry goes in before the emit loop (the last
            # emission may resolve the request, which writes the ticks
            # out) and counts the tokens emitted, not the acc + 1 the
            # device committed: the detail sums to the reply.
            tick_entry = None
            if srec is not None:
                if len(tr.ticks) < tr.MAX_TICKS:
                    tick_entry = [p["dispatched_at"], t1, 0]
                    tr.ticks.append(tick_entry)
                else:
                    tr.ticks_overflow += 1
            emitted = 0
            for j in range(n):
                if self._states[s] is not st:
                    break  # retired inside the accepted run
                if tick_entry is not None:
                    tick_entry[2] += 1
                self._emit(s, int(nxt[s, j]))
                emitted += 1
            self.metrics.tokens_per_tick.observe(emitted)
        t2 = time.monotonic()
        self.metrics.tick_host.observe(t2 - t1)
        tp = obs_tracing.get()
        if tp is not None:
            tp.tick_phase("tick_device_wait", t0, t1 - t0)
            tp.tick_phase("tick_host", t1, t2 - t1)

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
        for ing in self._ingest.values():
            ing.request.future.set_exception(exc)
        self._clear_inflight_state()

    def _suspend_inflight(self, exc: BaseException) -> List[Request]:
        """The non-terminal restart path: every in-flight request (slots
        + taken-but-unlanded) as a resume request with its original
        future, then the slot bookkeeping reset.  Requests that cannot
        resume are resolved in place.  Returned in submission order."""
        pending = [st.request for st in self._states if st is not None]
        pending += list(self._taken)
        # Mid-ingestion requests emitted nothing: they re-ingest from
        # their prompt, and their landed chunks count as wasted prefill.
        pending += [ing.request for ing in self._ingest.values()]
        ingest_wasted = {ing.request.id: ing.landed - ing.started
                         for ing in self._ingest.values()}
        resumed = []
        for req in pending:
            # The restart's typed edge on every interrupted request's
            # span, before its resumption or failure is decided (a
            # terminate or drain resolution is not a restart).
            srec = req.future._spans
            if srec is not None and req.trace is not None:
                try:
                    srec.request_event(req.trace, "engine_restart",
                                       {"epoch": self._epoch})
                except Exception:  # pragma: no cover
                    pass
            r = self._resume_or_fail(req, exc)
            if r is not None:
                if r.id in ingest_wasted:
                    r._resume_wasted = max(r._resume_wasted,
                                           ingest_wasted[r.id])
                resumed.append(r)
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
        self._ingest = {}
        self.slots.release_all()
        if self.draft_slots is not None:
            self.draft_slots.release_all()
        self._reset_spec_state()
        # release_all dropped the prefix registry's pins too: a new
        # epoch, so that stale entries neither attach freed pages nor
        # unpin twice, and re-prefill at their next use.
        self._cache_epoch += 1
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
        self._spec_mask = None
        self._dtable_uploaded = -1
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
                obs_tracing.instant("engine_failed", {
                    "consecutive_failures": attempt,
                    "max_restarts": self.engine_cfg.max_restarts})
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
            # The tuner's scoring window must not straddle the restart:
            # its baseline predates the crash.  The next worked tick
            # opens a fresh window.
            if self._tuner is not None:
                try:
                    self._tuner.reset_window()
                except Exception:  # pragma: no cover - never gates recovery
                    pass
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
                    srec = req.future._spans
                    if srec is not None and req.trace is not None:
                        # The resume edge on the request's own span: which
                        # requests the restart interrupted and what their
                        # re-prefill costs.
                        try:
                            srec.request_event(
                                req.trace, "resume",
                                {"epoch": self._epoch,
                                 "wasted_tokens": req._resume_wasted})
                        except Exception:  # pragma: no cover
                            pass
                obs_tracing.instant("requests_resumed", {
                    "count": len(resumed), "epoch": self._epoch})
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
        if self._spec:
            # The draft pool and the history reset in place too: the
            # speculative tick reads them by address.
            self._spec_tick.reset_inputs()
            if self.draft_slots is not None:
                self.draft_slots.reset()
            self._reset_spec_state()
        self._states = [None] * self.engine_cfg.n_slots
        self._ingest = {}
        self._reset_pipeline()
        # The pool is fresh: the registered prefixes' pages died with
        # it; their entries re-prefill, once, at their next use.
        self._cache_epoch += 1
        self._update_page_gauges()
        with self._hb_lock:
            self._epoch += 1
            self._stalled = False
            self._stall_hard_failed = False
        self.metrics.engine_restarts.inc()
        obs_tracing.instant("engine_restart", {
            "epoch": self._epoch,
            "restarts": self.metrics.engine_restarts.value})
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
        for ing in list(self._ingest.values()):
            ing.request.future.set_exception(exc)
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
        obs_tracing.instant("watchdog_stall", {
            "epoch": epoch,
            "budget_s": self.engine_cfg.tick_timeout,
            "tick_age_s": round(time.monotonic() - started, 3)})
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
        obs_tracing.instant("stall_hard_fail", {
            "epoch": epoch, "grace_s": self._stall_grace_s()})
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
        k <= max_prefills_per_tick) and its decode ticks, and one sampled
        group per k — on the card this captures every admission graph
        those shapes reach (``prefill_compilations``,
        ``sample_compilations``) before real traffic, as the JAX
        ``warmup`` compiles them.  Registered prefixes warm their suffix
        graphs, ``prompt_lens`` as the suffix lengths; a prompt longer
        than ``prefill_chunk_tokens`` warms its chunks' graphs.  A shape
        no warmup reached is captured at its first use.  The device
        memory reserved before and after the sweep is kept
        (``warmup_reserved_bytes`` in :meth:`stats`).  Call it before
        :meth:`start`: no other thread touches the card during the
        captures.  The sweep's synthetic requests are kept out of the
        journal.

        A speculative engine owns two decode graphs, both captured here
        (``decode_compilations`` 2, as the JAX engine's two executables),
        and its sweep also runs one opted-out request (the plain tick
        in use) and, for a model draft, the draft pool's ``(max_len, 1)``
        prefill that a probe's rebuild replays (its ``(bucket, k)``
        prefills ride the sweep's admissions).  The sweep's acceptance
        says nothing of real traffic: the speculative state is reset
        after it."""
        cuda = self.device.type == "cuda"
        before = torch.cuda.memory_reserved(self.device) if cuda else 0
        with self._lock:
            self._tick.capture()
            if self._spec:
                self._spec_tick.capture()
        kmax = min(self.engine_cfg.max_prefills_per_tick,
                   self.engine_cfg.n_slots)
        prompts = [[0] * max(int(n), 1) for n in prompt_lens]
        # Registered prefixes: their suffix prefills too, with
        # prompt_lens as the suffix lengths.
        prompts += [list(e.tokens) + [0] * max(int(n), 1)
                    for e in list(self._prefixes.values())
                    for n in prompt_lens
                    if len(e.tokens) + int(n) + 2 <= self.slots.max_len]
        # Sampled groups, one per k: the first-token sampler's graphs.
        groups = [[(prompt, {})] * k for prompt in prompts
                  for k in range(1, kmax + 1)]
        groups += [[(prompts[0], dict(temperature=1.0, seed=i))
                    for i in range(k)]
                   for k in range(1, kmax + 1) if prompts]
        if self._spec and prompts:
            groups.append([(prompts[0], dict(speculative=False))])
        journal, self.journal = self.journal, None
        try:
            for group in groups:
                futs = [self.submit(prompt, max_new_tokens=2, **kw)
                        for prompt, kw in group]
                while not all(f.done() for f in futs):
                    self.step()
            while self._pending is not None:  # the pipeline's last tick
                self.step()
            if self._spec_model:
                with self._lock:
                    self._warm_draft_probe()
        finally:
            self.journal = journal
        if self._spec:
            self._reset_spec_state()
        if cuda:
            self._warm_reserved = (
                before, torch.cuda.memory_reserved(self.device))
        if self.engine_cfg.autotune and self._tuner is None:
            # Installed after the sweep: the knob space is read from the
            # graphs the sweep captured, and a tuner live during it could
            # shrink the admission batch and leave shapes uncaptured.
            from horovod_tpu_torch.tuning.tuner import OnlineTuner

            OnlineTuner.install(self)

    def _warm_draft_probe(self) -> None:
        """Capture the draft pool's ``(max_len, 1)`` prefill that a
        probe's rebuild replays (:meth:`_respec_slot`), landing only in
        the NULL page and writing no slot's position."""
        width = self.slots.max_len
        phys, off = self.draft_slots.landing_raw([], 1, bucket=width)
        g = self._draft_graphs.get(("full", width, 1))
        g.set(tokens=np.zeros((1, width), np.int64), lens=[1], slots=0,
              new_pos=0, valid=0, phys=phys, off=off)
        self._draft_graphs.run(g)

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

    def _update_achieved_flops(self) -> None:
        """Refresh ``serving_achieved_flops_per_sec`` from the token rate
        between samples (stats() calls and /metrics scrapes), over a
        window capped at ~60 s so it tracks the current load."""
        fpt = self.engine_cfg.model_flops_per_token
        if not fpt:
            return
        # Re-asserted on the current metrics object: a caller may swap in
        # a fresh ServingMetrics after warmup.
        metrics = self.metrics
        metrics.model_flops_per_token.set(fpt)
        now = time.monotonic()
        with self._rate_lock:
            if metrics is not self._rate_metrics:
                # A fresh ServingMetrics restarts the token counter at 0:
                # a base from the old one would make the rate negative.
                self._rate_samples.clear()
                self._rate_metrics = metrics
            self._rate_samples.append((now, metrics.tokens_generated.value))
            while (len(self._rate_samples) > 2
                   and now - self._rate_samples[0][0] > 60.0):
                self._rate_samples.pop(0)
            t0, n0 = self._rate_samples[0]
            n1 = self._rate_samples[-1][1]
        if now <= t0:
            return
        metrics.achieved_flops.set((n1 - n0) / (now - t0) * fpt)

    def refresh_windowed_gauges(self) -> None:
        """Refresh the rate-windowed gauges (achieved FLOP/s) without
        building a /stats snapshot: a /metrics scrape's hook."""
        self._update_achieved_flops()

    @property
    def decode_compilations(self) -> int:
        """Captures of the decode ticks' CUDA graphs (0 on the CPU): 1
        after warmup (2 on a speculative engine), and it stays there."""
        return self._tick.captures + (
            self._spec_tick.captures if self._spec else 0)

    def stats(self) -> Dict:
        age = self.heartbeat_age
        self._update_achieved_flops()
        return {
            **self.metrics.snapshot(),
            "state": self._health,
            "queue_depth": int(self.scheduler.depth),
            "occupancy": float(self.slots.occupancy),
            "engine_state": str(self._health),
            "heartbeat_age_s": round(age, 3) if age is not None else -1.0,
            # The front tier's contract: one device a replica (tensor
            # parallelism is not ported), and the rollout's label.
            "tp": 1,
            "mesh": "",
            "config_generation": int(self.engine_cfg.config_generation),
            "state_transitions": self.state_transitions,
            "error": self.error,
            "device": str(self.device),
            "n_slots": self.engine_cfg.n_slots,
            "slots_active": self.slots.active_count,
            "max_len": self.slots.max_len,
            "prefill_calls": self._prefill_calls,
            "prefill_chunk_tokens": self.engine_cfg.prefill_chunk_tokens,
            "slots_ingesting": len(self._ingest),
            "prefixes_registered": len(self._prefixes),
            "page_size": self.slots.page_size,
            "kv_dtype": str(self.slots._storage_dtype).replace("torch.", ""),
            "kv_pages_high_water": self.slots.pages_high_water,
            "overlap": self.engine_cfg.overlap,
            "resume": self.engine_cfg.resume,
            "journal_inflight":
                len(self.journal) if self.journal is not None else 0,
            # Captures of the decode tick's CUDA graph (0 on the CPU,
            # where the tick runs eagerly): 1 after warmup, whatever the
            # request mix and however many restarts.
            "decode_compilations": self.decode_compilations,
            # Captures of the admission graphs (0 on the CPU): prefills
            # per ("full", bucket, k) and ("suffix", prefix pages, bucket,
            # k), the first-token sampler per k; their seconds, and the
            # device memory reserved around the last warmup.
            "prefill_compilations": (
                self._graphs.captures["full"] + self._graphs.captures["suffix"]
                + (self._draft_graphs.captures["full"]
                   if self._draft_graphs is not None else 0)),
            "sample_compilations": self._graphs.captures["sample"],
            "prefill_capture_s": round(self._graphs.capture_s, 4),
            "warmup_reserved_bytes": list(self._warm_reserved),
            # The (bucket, k) whole-prompt prefill shapes used, as the
            # JAX engine lists its compiled ones; the suffix shapes
            # (prefix pages, bucket, k).
            "prefill_buckets": self._graphs.keys("full"),
            "prefill_suffix_shapes": self._graphs.keys("suffix"),
            # Process-wide kernel launch counts (CPU runs take the plain
            # versions and leave them at 0).
            "flash_fwd_launches": _attn.flash_fwd_launches,
            "paged_attend_launches": _pa.paged_attend_launches,
            "speculative": self._spec,
            "autotune": self._tuner is not None,
            **({"tuning": self._tuner.snapshot()}
               if self._tuner is not None else {}),
            **({
                "spec_k": self.engine_cfg.spec_k,
                "spec_draft": "model" if self._spec_model else "ngram",
                "spec_slots_live": int(self._spec_live.sum()),
                "draft_pages_free":
                    self.draft_slots.free_pages
                    if self.draft_slots is not None else None,
            } if self._spec else {}),
        }
