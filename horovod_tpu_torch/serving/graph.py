"""The serving engine's CUDA graphs: the decode tick, captured once, and
the admission path, captured per shape.

Counterpart of the JAX engine's jitted ``_tick``
(``horovod_tpu/serving/engine.py``): there the tick is one compiled
executable; here, on CUDA, it is one CUDA graph captured at warmup and
replayed every tick, so the host issues one replay instead of the ~600
small operations of the eager tick.  :class:`DecodeTick` owns the
tick's static inputs — tokens, the active mask and the page table — and
reads the sampling columns (:class:`~horovod_tpu_torch.serving.sampling.
SlotSampling`), the parameters and the page pool by address; the
engine refreshes the inputs with ``copy_`` before each run.

The tick: :func:`~horovod_tpu_torch.models.transformer.decode_step_paged`
with kernel K4 and no capacity check (the engine's host mirror proves
capacity), the sampled pick at key position ``pos + 1``, the max logit
(the engine's finiteness probe), and the picked tokens written back into
the token input, where the overlapped pipeline's next tick reads them.

A speculative engine also owns a :class:`SpecTick`, captured as one more
graph over the same token, mask and table inputs (the JAX engine's
speculative ``_tick`` beside its plain ``_ptick``): the draft (a
shallower model's ``k + 1`` greedy steps over its own paged pool, or
prompt lookup over a device-resident token history), one W-wide
:func:`~horovod_tpu_torch.models.transformer.decode_verify_paged` (K4 at
``R = G * W`` over the committed pages) and the select of each slot's
next input token ``t[s, acc[s]]``, written back into the token input as
the plain tick writes its pick.

Admission (:class:`PrefillGraphs`) is captured per shape, keyed like
the JAX engine's compile sets: a whole-prompt prefill per ``("full",
bucket, k)`` (the JAX ``_prefill_fn``), a suffix or chunk prefill over a
gathered prefix per ``("suffix", prefix pages, bucket, k)`` (the JAX
``_suffix_prefill``, whose prefix length is a traced scalar: here a
device scalar that K1 reads), and the first-token sampler per
``("sample", k)`` (the JAX ``_first_sample``).  Each prefill graph
prefills, lands its K/V in the pages and takes each row's argmax and
max logit (the engine's finiteness probe), so an admission is one
replay and one host sync.

Each capture counts ``xla_compiles_total{fn=}`` in the default registry
(:func:`~horovod_tpu_torch.obs.tracing.record_compile`) under the JAX
engine's function names: ``serving_decode`` for the tick and the
speculative tick, ``serving_prefill`` and ``serving_sample`` for
admission, ``serving_draft_prefill`` for the draft model's prefills.  It
runs inside the capture, where it only bumps a counter and enqueues a
timeline instant: no tensor, no CUDA call.

On the CPU there is no graph: :meth:`DecodeTick.run` and
:meth:`PrefillGraphs.run` run the same bodies eagerly.  On CUDA a
capture or replay that fails raises; there is no eager fallback.

Transfers never wait for the device: :func:`upload_into` stages host
data through pinned memory and copies without blocking, and
:func:`download` starts pinned device-to-host copies and records an
event that :meth:`Download.wait` waits on.  PyTorch's caching host
allocator keeps a pinned block from reuse until the copy recorded on
it has completed, so a staging buffer is never rewritten in flight.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from horovod_tpu_torch._capture import capture
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.obs import tracing as obs_tracing
from horovod_tpu_torch.ops import attention as attn
from horovod_tpu_torch.ops import paged_attention as pa

__all__ = ["DecodeTick", "Download", "PrefillGraphs", "SpecTick", "download",
           "upload", "upload_into"]

#: Eager runs of a graph's body on a side stream before its capture
#: (the tick with every slot inactive, a prefill landing only in the
#: NULL page): they build the kernels and warm the libraries' handles,
#: which must not happen during capture.
CAPTURE_WARMUP_RUNS = 2


def _pinned(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).pin_memory()


def upload_into(dst: torch.Tensor, arr) -> None:
    """Copy a host array into the device tensor ``dst`` (same shape),
    through pinned memory and without waiting for the device."""
    arr = np.asarray(arr)
    if dst.is_cuda:
        dst.copy_(_pinned(arr), non_blocking=True)
    else:
        dst.copy_(torch.from_numpy(arr))


def upload(arr, device: torch.device) -> torch.Tensor:
    """A new device tensor holding a host array (pinned, non-blocking
    on CUDA)."""
    arr = np.asarray(arr)
    if torch.device(device).type == "cuda":
        return _pinned(arr).to(device, non_blocking=True)
    return torch.from_numpy(arr.copy())


class Download:
    """Device-to-host copies in flight; :meth:`wait` is the host sync."""

    def __init__(self, host: List[torch.Tensor],
                 event: Optional[torch.cuda.Event]):
        self._host = host
        self._event = event

    def wait(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [t.numpy() for t in self._host]


def download(*tensors: torch.Tensor) -> Download:
    """Start copying ``tensors`` to the host: into fresh pinned buffers
    with one event on CUDA (the caller may overwrite the sources once
    the copies are enqueued); CPU tensors are kept as they are."""
    if not tensors[0].is_cuda:
        return Download(list(tensors), None)
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return Download(host, event)


class DecodeTick:
    """One decode tick over all slots, with its static inputs.

    ``pool`` is the page pool (updated in place by the tick), ``samp``
    the four sampling columns; both are read by address.  On CUDA the
    first :meth:`run` captures the tick (or :meth:`capture` does, at
    warmup) and every run replays it; :attr:`captures` and
    :attr:`replays` count them.  K4's wrapper runs once a layer during
    capture, where it launches nothing: the count it adds there is taken
    back, and each replay adds that many launches, so
    ``paged_attention.paged_attend_launches`` still counts launches."""

    def __init__(self, params, cfg: T.TransformerConfig, pool, samp,
                 n_slots: int, max_pages: int, device: torch.device):
        self.params = params
        self.cfg = cfg
        self.pool = pool
        self.samp = samp
        self.device = torch.device(device)
        dev = self.device
        self.tokens = torch.zeros(n_slots, dtype=torch.int64, device=dev)
        self.active = torch.zeros(n_slots, dtype=torch.bool, device=dev)
        self.table = torch.zeros((n_slots, max_pages), dtype=torch.int32,
                                 device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captures = 0
        self.replays = 0
        self.runs = 0  # runs of either kind, eager or replayed
        self.k4_launches_per_replay = 0
        self.k4_rows_per_replay: Dict[int, int] = {}
        self._out = None

    @property
    def graphed(self) -> bool:
        return self.device.type == "cuda"

    def body(self):
        """The tick's operations: ``(next tokens (S,) int64, max logit
        (S,) f32)``; inactive rows pick token 0."""
        key_pos = self.pool["pos"].long() + 1  # the picked token's position
        logits, _ = T.decode_step_paged(
            self.params, self.tokens, self.pool, self.table, self.cfg,
            self.active, kernel=True, check_capacity=False)
        s_t, s_k, s_p, s_key = self.samp
        nxt = T.sample_token_rows(logits, s_t, s_k, s_p, s_key, key_pos,
                                  torch.zeros_like(key_pos))
        nxt = torch.where(self.active, nxt, torch.zeros_like(nxt))
        self.tokens.copy_(nxt)
        return nxt, logits.amax(dim=-1)

    def capture(self) -> None:
        """Capture the tick as a CUDA graph (CUDA only; once).  The warmup
        runs go with every slot inactive: inactive rows write only to the
        NULL page and keep their positions, so nothing a slot reads
        changes; the token and mask inputs are restored after."""
        _capture_tick(self, (self.tokens, self.active))

    def reset_inputs(self) -> None:
        """Zero the token, mask and table inputs in place (the
        supervised restart): the graph keeps reading the same tensors,
        so a restart never recaptures."""
        for t in (self.tokens, self.active, self.table):
            t.zero_()

    def twin(self) -> "DecodeTick":
        """An uncaptured tick over copies of this one's pool, inputs and
        sampling columns: its :meth:`body` is the eager tick to hold the
        captured one against."""
        t = DecodeTick(self.params, self.cfg,
                       {k: v.clone() for k, v in self.pool.items()},
                       tuple(c.clone() for c in self.samp),
                       self.tokens.shape[0], self.table.shape[1],
                       self.device)
        for name in ("tokens", "active", "table"):
            getattr(t, name).copy_(getattr(self, name))
        return t

    def run(self):
        """One tick: a replay on CUDA (capturing first if needed), the
        eager body on the CPU.  Returns ``(next tokens, max logit)``
        device tensors; on CUDA the same tensors every replay."""
        self.runs += 1
        if not self.graphed:
            return self.body()
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1
        _count_k4(self)
        return self._out


def _count_k4(tick) -> None:
    """Add a replay's K4 launches to the wrapper's counters (in all and
    by query rows), as if the body's wrapper calls had launched."""
    pa.paged_attend_launches += tick.k4_launches_per_replay
    for r, n in tick.k4_rows_per_replay.items():
        pa.paged_attend_launches_by_rows[r] = (
            pa.paged_attend_launches_by_rows.get(r, 0) + n)


def _capture_tick(tick, inputs) -> None:
    """Capture ``tick.body`` (CUDA only; once): warm runs on a side
    stream with every slot inactive — inactive rows write only to the
    NULL page, keep their positions and commit nothing — then the
    capture.  K4's capture-time count is taken back into
    ``tick.k4_launches_per_replay``; ``inputs`` (tensors the body
    rewrites: the token vector, the mask) hold what they held before."""
    if not tick.graphed or tick.graph is not None:
        return
    saved = [t.clone() for t in inputs]
    tick.active.zero_()
    stream = torch.cuda.current_stream(tick.device)
    side = torch.cuda.Stream(tick.device)
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        for _ in range(CAPTURE_WARMUP_RUNS):
            tick.body()
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    k4, rows = pa.paged_attend_launches, dict(pa.paged_attend_launches_by_rows)
    with capture(graph):
        out = tick.body()
        obs_tracing.record_compile("serving_decode")
    tick.k4_launches_per_replay = pa.paged_attend_launches - k4
    tick.k4_rows_per_replay = {
        r: n - rows.get(r, 0)
        for r, n in pa.paged_attend_launches_by_rows.items()
        if n != rows.get(r, 0)}
    pa.paged_attend_launches = k4
    pa.paged_attend_launches_by_rows.clear()
    pa.paged_attend_launches_by_rows.update(rows)
    tick.graph, tick._out = graph, out
    tick.captures += 1
    for t, v in zip(inputs, saved):
        t.copy_(v)


class SpecTick:
    """The speculative tick over all slots, beside the plain
    :class:`DecodeTick` ``plain``, whose token, mask and table inputs,
    sampling columns, parameters and pool it reads by address, so the
    engine switches between the two ticks with no host round trip.

    Its own inputs: ``spec_on`` (S,) bool, the slots whose drafts may be
    accepted (the per-request opt-out, adaptive disabling); for a model
    draft (``draft = (params, cfg, pool)``) the draft pool's page table
    ``dtable``; for the n-gram draft the committed-token history
    ``hist`` ``(S, max_len + 1)``, whose last column is a trash column:
    a write that must land nowhere (an inactive row, a rejected draft, a
    position past the history) lands there, where no proposal reads.

    The body: the n-gram history takes each active slot's input token
    at its position, or the draft pool's ``pos`` follows the target's;
    ``k`` drafts (:func:`~horovod_tpu_torch.models.transformer.
    ngram_propose` or :func:`~horovod_tpu_torch.models.transformer.
    draft_propose_paged`, K4 once a draft layer a step); one
    :func:`~horovod_tpu_torch.models.transformer.decode_verify_paged`
    over the window (K4 at ``R = G * (k + 1)``, sampled rows drawn at
    offset 0); the accepted drafts committed to the history, or the
    draft pool's ``pos`` set back to the target's; each slot's next
    input ``t[s, acc[s]]`` (0 for inactive rows) written into the token
    input.  It returns ``(t (S, W), max logit (S, W), acc (S,))``.  On
    CUDA it is captured once and replayed, as :class:`DecodeTick` is;
    K4's launches a replay are ``(k + 1) * L_draft + L`` for a model
    draft, ``L`` for the n-gram one."""

    def __init__(self, plain: DecodeTick, k: int, max_len: int,
                 draft: Optional[Tuple] = None):
        self.plain = plain
        self.k = k
        self.draft = draft
        self.device = plain.device
        S = plain.tokens.shape[0]
        self.spec_on = torch.zeros(S, dtype=torch.bool, device=self.device)
        self.dtable = (torch.zeros_like(plain.table) if draft is not None
                       else None)
        self.hist = (torch.zeros((S, max_len + 1), dtype=torch.int64,
                                 device=self.device)
                     if draft is None else None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captures = 0
        self.replays = 0
        self.runs = 0
        self.k4_launches_per_replay = 0
        self.k4_rows_per_replay: Dict[int, int] = {}
        self._out = None

    @property
    def graphed(self) -> bool:
        return self.device.type == "cuda"

    @property
    def active(self) -> torch.Tensor:
        return self.plain.active

    def body(self):
        pl = self.plain
        pool, tokens, active = pl.pool, pl.tokens, pl.active
        pos0 = pool["pos"].long()  # entry positions (a copy)
        rows = torch.arange(tokens.shape[0], device=self.device)
        if self.draft is None:
            th = self.hist.shape[1] - 1  # the trash column
            trash = torch.full_like(pos0, th)
            hidx = torch.where(active & (pos0 < th), pos0, trash)
            self.hist[rows, hidx] = tokens
            drafts = T.ngram_propose(self.hist[:, :th], pos0, self.k)
        else:
            dparams, dcfg, dpool = self.draft
            # The draft's position follows the target's at entry too: a
            # rebuilt draft state may lag the device by a tick in flight.
            dpool["pos"].copy_(pool["pos"])
            drafts, _ = T.draft_propose_paged(dparams, tokens, dpool,
                                              self.dtable, dcfg, active,
                                              self.k, kernel=True)
        window = torch.cat([tokens[:, None], drafts], dim=1)
        t, mx, acc, _ = T.decode_verify_paged(
            pl.params, window, pool, pl.table, pl.cfg, active, self.spec_on,
            sample=pl.samp, kernel=True)
        if self.draft is None:
            # Accepted drafts are committed history too.
            j = torch.arange(1, self.k + 1, device=self.device)[None, :]
            wp = pos0[:, None] + j
            ok = active[:, None] & (j <= acc[:, None]) & (wp < th)
            self.hist[rows[:, None],
                      torch.where(ok, wp, torch.full_like(wp, th))] = drafts
        else:
            # Rollback of the rejected tail: the committed depth; its
            # stale K/V is overwritten before it is ever attended.
            dpool["pos"].copy_(pool["pos"])
        nxt = t[rows, acc]
        self.plain.tokens.copy_(torch.where(active, nxt,
                                            torch.zeros_like(nxt)))
        return t, mx, acc

    def capture(self) -> None:
        """Capture the tick as a CUDA graph (CUDA only; once), as
        :class:`DecodeTick` captures."""
        _capture_tick(self, (self.plain.tokens, self.plain.active))

    def reset_inputs(self) -> None:
        """Zero the tick's own inputs in place (the supervised restart;
        the plain tick resets the shared ones)."""
        for t in (self.spec_on, self.dtable, self.hist):
            if t is not None:
                t.zero_()

    def twin(self) -> "SpecTick":
        """An uncaptured speculative tick over copies of this one's state
        (a :meth:`DecodeTick.twin` of the plain tick, the draft pool, the
        history): its :meth:`body` is the eager tick to hold the captured
        one against."""
        draft = None
        if self.draft is not None:
            dparams, dcfg, dpool = self.draft
            draft = (dparams, dcfg, {k: v.clone() for k, v in dpool.items()})
        max_len = self.hist.shape[1] - 1 if self.hist is not None else 0
        t = SpecTick(self.plain.twin(), self.k, max_len, draft)
        for name in ("spec_on", "dtable", "hist"):
            if getattr(self, name) is not None:
                getattr(t, name).copy_(getattr(self, name))
        return t

    def run(self):
        """One speculative tick: a replay on CUDA (capturing first if
        needed), the eager body on the CPU -> ``(t, max logit, acc)``
        device tensors; on CUDA the same tensors every replay."""
        self.runs += 1
        if not self.graphed:
            return self.body()
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1
        _count_k4(self)
        return self._out


class _Packed:
    """Static inputs of one dtype packed into one device tensor, with a
    host mirror: each field is a view of both, and :meth:`upload`
    refreshes the device tensor with one copy (``upload_into``)."""

    def __init__(self, fields: Sequence[Tuple[str, tuple]], dtype,
                 device: torch.device):
        n = sum(int(np.prod(shape)) for _, shape in fields)
        self.host = np.zeros(n, dtype)
        self.dev = torch.zeros(n, dtype=torch.from_numpy(self.host).dtype,
                               device=device)
        self.h: Dict[str, np.ndarray] = {}
        self.d: Dict[str, torch.Tensor] = {}
        at = 0
        for name, shape in fields:
            size = int(np.prod(shape))
            self.h[name] = self.host[at:at + size].reshape(shape)
            self.d[name] = self.dev[at:at + size].view(shape)
            at += size

    def upload(self) -> None:
        upload_into(self.dev, self.host)


class PrefillGraph:
    """One admission shape: its key, its static inputs (filled with
    :meth:`set`), and on CUDA its graph and the outputs every replay
    rewrites.

    Keys and fields (all int64 unless said):

    * ``("full", bucket, k)`` and ``("suffix", n_pages, bucket, k)``:
      ``tokens`` (k, bucket) right-padded, ``lens`` (k,) real lengths;
      the landing — ``slots`` (k,), ``new_pos`` (k,), ``valid`` (k,)
      (0: leave the slot's position; a prefix registration lands in
      pages of no slot), ``phys`` and ``off`` (k, bucket); for
      ``suffix`` also ``p0`` () the prefix length and ``pages``
      (n_pages,) the prefix's page ids, NULL-padded.
    * ``("sample", k)``: ``keys`` (k, 2), ``top_k`` (k,), ``pos`` (k,);
      f32 ``temp`` (k,), ``top_p`` (k,); and :attr:`logits` (k, V) f32,
      filled by a device copy."""

    def __init__(self, key: tuple, vocab: int, device: torch.device):
        self.key = key
        kind = key[0]
        floats: List = []
        if kind == "sample":
            k = key[1]
            ints = [("keys", (k, 2)), ("top_k", (k,)), ("pos", (k,))]
            floats = [("temp", (k,)), ("top_p", (k,))]
        elif kind in ("full", "suffix"):
            bucket, k = key[-2:]
            ints = [("tokens", (k, bucket)), ("lens", (k,)),
                    ("slots", (k,)), ("new_pos", (k,)), ("valid", (k,)),
                    ("phys", (k, bucket)), ("off", (k, bucket))]
            if kind == "suffix":
                ints += [("p0", ()), ("pages", (key[1],))]
        else:
            raise ValueError(f"unknown admission graph kind {kind!r}")
        self.ints = _Packed(ints, np.int64, device)
        self.floats = _Packed(floats, np.float32, device) if floats else None
        self.logits = (torch.zeros((key[1], vocab), dtype=torch.float32,
                                   device=device)
                       if kind == "sample" else None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.k1_launches_per_replay = 0

    def set(self, **fields) -> None:
        """Write host values into the named fields (the next run
        uploads them)."""
        for name, val in fields.items():
            packed = self.ints if name in self.ints.h else self.floats
            packed.h[name][...] = val

    def upload(self) -> None:
        self.ints.upload()
        if self.floats is not None:
            self.floats.upload()


class PrefillGraphs:
    """The admission path's graphs over one model and one page pool,
    keyed as :class:`PrefillGraph` says, created at first use.

    ``pool`` (the page pool, written by every prefill graph's landing)
    and the parameters are read by address, as :class:`DecodeTick` reads
    them, so a restart (the pool zeroed in place) or a copy-on-write
    never recaptures.  On CUDA :meth:`run` captures a key's graph at its
    first run (warm eager runs on a side stream first, landing only in
    the NULL page) and replays it from then on; every graph shares one
    memory pool, so a graph's outputs hold until the next replay of any
    of them: a caller that keeps one past that clones it.  K1's wrapper
    runs once a layer during capture, where it launches nothing: the
    count it adds there is taken back, and each replay adds that many
    launches, so ``attention.flash_fwd_launches`` still counts launches.
    :attr:`captures` counts captures by kind, :attr:`capture_s` their
    seconds (warm runs included), :meth:`keys` the keys run so far.
    ``draft``: the graphs of a speculative engine's draft model (their
    captures count as ``serving_draft_prefill``)."""

    def __init__(self, params, cfg: T.TransformerConfig, pool: Dict,
                 device: torch.device, draft: bool = False):
        # Imported here: cache.py imports this module's upload helpers.
        from horovod_tpu_torch.serving import cache

        self._cache = cache
        self.params = params
        self.cfg = cfg
        self.pool = pool
        self.device = torch.device(device)
        self._graphs: Dict[tuple, PrefillGraph] = {}
        self._used: set = set()
        self._mempool = None
        self.captures = {"full": 0, "suffix": 0, "sample": 0}
        # xla_compiles_total's fn label a capture counts under, by kind.
        prefill = "serving_draft_prefill" if draft else "serving_prefill"
        self._compile_fn = {"full": prefill, "suffix": prefill,
                            "sample": "serving_sample"}
        self.capture_s = 0.0
        self.replays = 0

    @property
    def graphed(self) -> bool:
        return self.device.type == "cuda"

    def get(self, key: tuple) -> PrefillGraph:
        """The key's graph (static inputs made at first use)."""
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = PrefillGraph(key, self.cfg.vocab_size,
                                                 self.device)
        return g

    def keys(self, kind: str) -> List[tuple]:
        """The keys of ``kind`` run so far, sorted, without the kind."""
        return sorted(k[1:] for k in self._used if k[0] == kind)

    def body(self, g: PrefillGraph):
        """The key's operations on its static inputs.  A prefill returns
        ``(last-position logits (k, V) f32, argmax (k,) int64, max logit
        (k,) f32)`` and has landed its K/V; the sampler returns ``(tokens
        (k,) int64, max logit (k,) f32)``: rows with temperature 0 take
        the argmax, the others draw at key position ``pos``."""
        f = g.ints.d
        kind = g.key[0]
        if kind == "sample":
            fl = g.floats.d
            toks = T.sample_token_rows(g.logits, fl["temp"], f["top_k"],
                                       fl["top_p"], f["keys"], f["pos"],
                                       torch.zeros_like(f["pos"]))
            return toks, g.logits.amax(dim=-1)
        if kind == "full":
            k, bucket = f["tokens"].shape
            cache = T.init_cache(self.cfg, k, bucket, device=self.device)
            logits, kv = T.prefill(self.params, f["tokens"], cache, self.cfg,
                                   true_len=f["lens"])
        else:
            pk, pv = self._cache.gather_prefix_pages(self.pool, f["pages"])
            logits, kv = T.prefill_with_prefix(
                self.params, f["tokens"], pk, pv, f["p0"], self.cfg,
                true_len=f["lens"])
        pos = torch.where(f["valid"] > 0, f["new_pos"],
                          self.pool["pos"][f["slots"]].long())
        self._cache.paged_insert(self.pool, f["slots"], pos, f["phys"],
                                 f["off"], kv["k"], kv["v"])
        return logits, torch.argmax(logits, dim=-1), logits.amax(dim=-1)

    def capture(self, g: PrefillGraph) -> None:
        """Capture ``g`` (CUDA only; once): warm runs of its body on a
        side stream, landing only in the NULL page and writing no slot's
        position, then the capture into the shared memory pool.  Its
        static inputs hold what they held before."""
        if not self.graphed or g.graph is not None:
            return
        t0 = time.monotonic()
        saved = g.ints.dev.clone()
        if g.key[0] != "sample":
            g.ints.d["phys"].zero_()
            g.ints.d["valid"].zero_()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP_RUNS):
                self.body(g)
        stream.wait_stream(side)
        g.ints.dev.copy_(saved)
        if self._mempool is None:
            self._mempool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        k1 = attn.flash_fwd_launches
        with capture(graph, self._mempool):
            out = self.body(g)
            obs_tracing.record_compile(self._compile_fn[g.key[0]])
        g.k1_launches_per_replay = attn.flash_fwd_launches - k1
        attn.flash_fwd_launches = k1
        g.graph, g.out = graph, out
        self.captures[g.key[0]] += 1
        self.capture_s += time.monotonic() - t0

    def run(self, g: PrefillGraph):
        """Upload ``g``'s static inputs and run it: a replay on CUDA
        (capturing first if needed), the eager body on the CPU.  Returns
        :meth:`body`'s tensors; on CUDA the same tensors every replay."""
        g.upload()
        self._used.add(g.key)
        if not self.graphed:
            return self.body(g)
        if g.graph is None:
            self.capture(g)
        g.graph.replay()
        self.replays += 1
        attn.flash_fwd_launches += g.k1_launches_per_replay
        return g.out
