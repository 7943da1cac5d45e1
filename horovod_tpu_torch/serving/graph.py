"""The serving engine's decode tick, captured once as a CUDA graph.

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

On the CPU there is no graph: :meth:`DecodeTick.run` runs the same body
eagerly.  On CUDA a capture or replay that fails raises; there is no
eager fallback.

Transfers never wait for the device: :func:`upload_into` stages host
data through pinned memory and copies without blocking, and
:func:`download` starts pinned device-to-host copies and records an
event that :meth:`Download.wait` waits on.  PyTorch's caching host
allocator keeps a pinned block from reuse until the copy recorded on
it has completed, so a staging buffer is never rewritten in flight.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import paged_attention as pa

__all__ = ["DecodeTick", "Download", "download", "upload", "upload_into"]

#: Eager runs of the tick, with every slot inactive, on a side stream
#: before the capture: they build the kernels and warm the libraries'
#: handles, which must not happen during capture.
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
        self.k4_launches_per_replay = 0
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
        if not self.graphed or self.graph is not None:
            return
        saved = (self.tokens.clone(), self.active.clone())
        self.active.zero_()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP_RUNS):
                self.body()
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        k4 = pa.paged_attend_launches
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self.body()
        self.k4_launches_per_replay = pa.paged_attend_launches - k4
        pa.paged_attend_launches = k4
        self.graph, self._out = graph, out
        self.captures += 1
        self.tokens.copy_(saved[0])
        self.active.copy_(saved[1])

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
        if not self.graphed:
            return self.body()
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1
        pa.paged_attend_launches += self.k4_launches_per_replay
        return self._out
