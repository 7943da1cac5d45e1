"""Continuous-batching inference engine: the paged path with per-slot
sampling, the overlapped decode pipeline and the tick as one CUDA graph.

Counterpart of ``horovod_tpu/serving/engine.py`` in its default
configuration (``paged=True``, ``overlap=True``, sampling as data).  One
decode tick runs over a fixed pool of S slots; new requests land in
freed slots between ticks.

Tick (:meth:`InferenceEngine.step`):

1. **Admit**: take up to K = ``max_prefills_per_tick`` queued requests
   that share one prompt bucket (prompts right-padded to a power of two,
   at least ``min_prefill_bucket``), grant each the pages its prompt
   needs, run ONE batch-K prefill (flash kernel K1 on the card) and land
   its K/V in the granted pages.  The prefill's last-position logits
   give each request its first token: the argmax for an all-greedy
   group, else the sampler at key position ``len(prompt)``.
2. **Decode**: grant every active slot the page under its next write
   position, then ONE :class:`~horovod_tpu_torch.serving.graph.
   DecodeTick` over all S slots — ``decode_step_paged`` (paged-attention
   kernel K4 on the card) and the per-slot sampled pick — with the page
   table, the active mask and the sampling columns as data.  On CUDA the
   tick is one CUDA graph captured at :meth:`~InferenceEngine.warmup`
   (or at the first tick) and replayed; ``decode_compilations`` counts
   captures and stays 1 across any request mix.

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

Failures: a tick that raises — non-finite logits included — resolves
every in-flight and queued future with
:class:`~horovod_tpu_torch.serving.scheduler.EngineFailedError`, leaves
the engine ``failed`` and re-raises.  There are no supervised restarts
in the port yet.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import attention as _attn
from horovod_tpu_torch.ops import paged_attention as _pa
from horovod_tpu_torch.serving.cache import NULL_PAGE, PagedSlotCache
from horovod_tpu_torch.serving.graph import (
    DecodeTick,
    download,
    upload,
    upload_into,
)
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
    Request,
    RequestTooLongError,
    Scheduler,
    ServingError,
)

__all__ = ["EngineConfig", "GenerationFuture", "InferenceEngine",
           "HEALTHY", "DRAINING", "FAILED"]

HEALTHY = "healthy"
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
        # Resolution is serialized: a caller-side resolution (a submit
        # racing a drain) and the engine's must not both land.
        self._resolve_lock = threading.Lock()
        self.finish_reason: Optional[str] = None
        self.ttft: Optional[float] = None

    def _add_token(self, tok: int) -> bool:
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

    def set_exception(self, exc: BaseException) -> None:
        with self._resolve_lock:
            if self._done.is_set():
                return
            self._exc = exc
            self._done.set()

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
    docstring), ``False`` as the synchronous tick."""

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


@dataclasses.dataclass
class _SlotState:
    request: Request
    last_token: int
    n_generated: int


class InferenceEngine:
    """Continuous-batching engine over one model's params + config.

    Drive it synchronously with :meth:`step` or as a background thread
    with :meth:`start` / :meth:`stop` (the HTTP server).  The engine runs
    on CUDA unless ``device="cpu"`` is passed; ``params`` must already
    live on that device (:func:`~horovod_tpu_torch.models.transformer.
    init_params`, :func:`~horovod_tpu_torch.models.convert.
    params_from_jax`)."""

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
            on_expire=lambda req: self.metrics.completed.inc())
        self._states: List[Optional[_SlotState]] = [None] * ec.n_slots
        # Requests taken from the queue but not yet in a slot: a tick
        # failing mid-admission must resolve these too.
        self._taken: List[Request] = []
        self._lock = threading.Lock()  # engine-loop state (step is serial)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._health = HEALTHY
        self._draining = False
        self.error: Optional[str] = None
        self._last_tick_done: Optional[float] = None
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
        self._prefill_calls = 0
        self.metrics.kv_pages_total.set(self.slots.n_pages)
        self.metrics.kv_bytes_per_token.set(self.slots.bytes_per_token)
        self._update_page_gauges()

    # -- lifecycle ---------------------------------------------------------

    @property
    def health(self) -> str:
        """healthy | draining | failed."""
        return self._health

    @property
    def heartbeat_age(self) -> Optional[float]:
        """Seconds since the last completed tick (None before the first)."""
        t = self._last_tick_done
        return time.monotonic() - t if t is not None else None

    def begin_drain(self) -> None:
        """New :meth:`submit` calls raise :class:`DrainingError`; admitted
        and queued requests keep running."""
        self._draining = True
        if self._health != FAILED:
            self._health = DRAINING

    # -- submission --------------------------------------------------------

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               deadline: Optional[float] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, seed: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None
               ) -> GenerationFuture:
        """Queue a generation request; returns its future.

        ``temperature`` / ``top_k`` / ``top_p`` / ``seed`` select
        sampling (temperature 0, the default, is greedy); the tokens equal
        ``sample_decode`` of the same prompt with ``rng=seed_key(seed)``.
        ``on_token`` is the future's per-token hook.

        Typed rejections, raised here: :class:`ServingError` (empty or
        out-of-vocabulary prompt, ``max_new_tokens < 1``, a bad sampling
        parameter), :class:`RequestTooLongError`,
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
            raise EngineFailedError(f"engine has failed ({self.error})")
        temperature, top_k, top_p, seed = validate(temperature, top_k,
                                                   top_p, seed)
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
        req = Request(prompt=prompt, max_new_tokens=n_new, future=fut,
                      eos_id=eos_id, deadline=deadline,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed)
        self.scheduler.submit(req)  # QueueFullError counts via on_reject
        # Re-check after the enqueue: a failure or drain that began
        # between the checks above and the enqueue must not strand it.
        if self._health == FAILED or self._draining:
            exc = (EngineFailedError("engine failed during submit")
                   if self._health == FAILED
                   else DrainingError("engine began draining during submit"))
            fut.set_exception(exc)
            raise exc
        self.metrics.queue_depth.set(self.scheduler.depth)
        return fut

    # -- the tick ----------------------------------------------------------

    def step(self) -> bool:
        """One tick: admit, then one decode over all slots (pipelined
        with ``overlap``).  Returns True if any work was done.  A failure
        resolves every in-flight and queued future with
        :class:`EngineFailedError`, leaves the engine ``failed`` and
        re-raises."""
        if self._health == FAILED:
            return False
        try:
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
        except Exception as exc:
            self._fail(exc)
            raise
        self._last_tick_done = time.monotonic()
        return worked

    def _fail(self, exc: BaseException) -> None:
        self.metrics.engine_failures.inc()
        self.error = f"{type(exc).__name__}: {exc}"
        err = exc if isinstance(exc, EngineFailedError) else \
            EngineFailedError(f"engine tick failed: {self.error}")
        # FAILED before the queue is drained: a submit racing this sees
        # it on its post-enqueue check if the drain missed its request.
        self._health = FAILED
        self._resolve_all(err)

    def _resolve_all(self, exc: BaseException) -> None:
        """Resolve every in-flight and queued future with ``exc`` and
        reset the slot bookkeeping."""
        for st in self._states:
            if st is not None:
                st.request.future.set_exception(exc)
        for req in self._taken:
            req.future.set_exception(exc)
        for req in self.scheduler.drain_pending():
            req.future.set_exception(exc)
        self._taken = []
        self._states = [None] * self.engine_cfg.n_slots
        self.slots.release_all()
        self._samp.reset()
        self._page_pos[:] = 0
        self._pending = None
        self._tokens_live = False

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

    def _admit_pending(self) -> bool:
        swept = self.scheduler.sweep()
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
        return bool(reqs) or bool(swept)

    def _admit_batch(self, reqs: List[Request]) -> None:
        """Grant the prompt pages, run ONE batch-K prefill (one bucket),
        land its K/V with one scatter, and emit each first token."""
        t_adm = time.monotonic()
        slots: List[int] = []
        live: List[Request] = []
        for req in reqs:
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
        position ``len(prompt)`` (greedy rows still take the argmax)."""
        if all(r.temperature <= 0.0 for r in reqs):
            return torch.argmax(logits, dim=-1).tolist()
        dev = self.device
        cols = [np.array([r.temperature for r in reqs], np.float32),
                np.array([r.top_k for r in reqs], np.int64),
                np.array([r.top_p for r in reqs], np.float32),
                np.stack([seed_key(r.seed) for r in reqs]).astype(np.int64),
                np.array([len(r.prompt) for r in reqs], np.int64)]
        temp, tk, tp, keys, pos = (upload(c, dev) for c in cols)
        return T.sample_token_rows(logits, temp, tk, tp, keys, pos,
                                   torch.zeros_like(pos)).tolist()

    def _prepare_paged_tick(self) -> None:
        """Tick-boundary page maintenance: every active slot gets a page
        under its write position, then the tick's table is refreshed iff
        it changed."""
        ps = self.slots.page_size
        for s in range(self.engine_cfg.n_slots):
            st = self._states[s]
            if st is None:
                continue
            wp = int(self._page_pos[s])
            last_real = len(st.request.prompt) + st.request.max_new_tokens - 2
            if wp > min(last_real, self.slots.max_len - 1):
                continue
            while (self._states[s] is st
                   and self.slots.table[s, wp // ps] == NULL_PAGE):
                try:
                    self.slots.grant(s, wp // ps)
                except CacheOutOfPagesError:
                    if not self._evict_for_pages():
                        raise
        if self._table_uploaded != self.slots.table_version:
            upload_into(self._tick.table, self.slots.table)
            self._table_uploaded = self.slots.table_version

    def _evict_for_pages(self) -> bool:
        """Pool exhausted by decode growth: fail the youngest occupant
        (highest request id) with :class:`CacheOutOfPagesError` so older
        requests keep progressing.  False when no slot is occupied."""
        occ = [(st.request.id, s) for s, st in enumerate(self._states)
               if st is not None]
        if not occ:
            return False
        _, s = max(occ)
        self._states[s].request.future.set_exception(CacheOutOfPagesError(
            "preempted: the page pool is exhausted; retry with backoff"))
        self.metrics.rejected.inc()
        self._release(s)
        return True

    def _emit(self, slot: int, tok: int) -> None:
        """Stream one token to the slot's future; retire on EOS,
        max-token, capacity or a lapsed deadline."""
        st = self._states[slot]
        if st is None:
            return
        if not st.request.future._add_token(tok):
            self._release(slot)  # resolved elsewhere
            return
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
        nxt, mx = self._tick.run()
        fetch = download(nxt, mx)
        self._page_pos += active
        self.metrics.decode_ticks.inc()
        self.metrics.tick_dispatch.observe(time.monotonic() - t0)
        return {"fetch": fetch, "active": active, "dispatched_at": t0,
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
            # Page grants before the mask snapshot: host bookkeeping and
            # a non-blocking table copy, nothing waits for the device.
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
        if prev is not None:
            self._retire_pending(prev)
            worked = True
        return worked

    def _retire_pending(self, p: Dict) -> None:
        """Fetch a dispatched tick's results — the one host sync of a
        steady-state step — check them and emit, for both modes.

        A slot's token is emitted only if the slot still holds the
        request it computed for at dispatch (the ``reqs`` snapshot).  A
        slot retired (EOS, length, deadline), cancelled or re-admitted
        between dispatch and fetch fails that check and its stale row is
        dropped: no token after EOS, and no token leaks into a slot's
        next tenant.  The stale row's K/V write is never read (write
        before attend).  In the synchronous tick the snapshot always
        matches."""
        t0 = time.monotonic()
        nxt, mx = p["fetch"].wait()
        self.metrics.host_syncs.inc()
        t1 = time.monotonic()
        self.metrics.tick_device_wait.observe(t1 - t0)
        active = p["active"]
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

    # -- background loop ---------------------------------------------------

    def start(self, idle_sleep: float = 0.001) -> None:
        """Run the tick loop in a daemon thread until :meth:`stop`.  A
        failed tick ends the loop (its error is in :attr:`error`, and
        every future is already resolved)."""
        if self._thread is not None:
            return

        def loop():
            while not self._stop.is_set():
                try:
                    worked = self.step()
                except Exception:
                    return
                if not worked:
                    time.sleep(idle_sleep)

        self._stop.clear()
        self._thread = threading.Thread(target=loop, name="serving-engine",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        self._thread = None

    def warmup(self, prompt_lens: Sequence[int] = (1,)) -> None:
        """Capture the decode tick (CUDA), then drive the engine
        synchronously through one admission per (prompt bucket, batch
        k <= max_prefills_per_tick) and its decode ticks — on the card
        this builds both kernels and warms their launch paths before
        real traffic.  Call it before :meth:`start`: no other thread
        touches the card during the capture."""
        with self._lock:
            self._tick.capture()
        kmax = min(self.engine_cfg.max_prefills_per_tick,
                   self.engine_cfg.n_slots)
        for n in prompt_lens:
            for k in range(1, kmax + 1):
                futs = [self.submit([0] * max(int(n), 1), max_new_tokens=2)
                        for _ in range(k)]
                while not all(f.done() for f in futs):
                    self.step()
        while self._pending is not None:  # retire the pipeline's last tick
            self.step()

    def drain(self, timeout: float = 60.0, poll: float = 0.002) -> bool:
        """Block until the queue, the slots and the pipeline are empty
        (True) or timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._health == FAILED:
                return True  # the failure resolved everything
            with self._lock:
                idle = (self.scheduler.depth == 0
                        and self.slots.active_count == 0 and not self._taken
                        and self._pending is None)
            if idle:
                return True
            if self._thread is None:
                self.step()
            else:
                time.sleep(poll)
        return False

    def terminate(self, reason: str = "engine terminated") -> None:
        """Resolve everything with :class:`EngineFailedError` and go
        ``failed`` (the drain-timeout escape hatch)."""
        self.error = self.error or reason
        self._health = FAILED
        locked = self._lock.acquire(timeout=1.0)
        try:
            self._resolve_all(EngineFailedError(reason))
        finally:
            if locked:
                self._lock.release()

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
            # Captures of the decode tick's CUDA graph (0 on the CPU,
            # where the tick runs eagerly): 1 after warmup, whatever the
            # request mix.  The first-token sampler runs eagerly.
            "decode_compilations": self._tick.captures,
            "sample_compilations": 0,
            # Process-wide kernel launch counts (CPU runs take the plain
            # versions and leave them at 0).
            "flash_fwd_launches": _attn.flash_fwd_launches,
            "paged_attend_launches": _pa.paged_attend_launches,
        }
