"""Input pipeline: rank-sharded, shuffled, device-prefetched batches.

Counterpart of ``horovod_tpu/data.py`` ``DataLoader``, with its
distributed contract kept as it is:

* **sharding by rank** with the lockstep guarantee: rank ``r`` of ``p``
  takes rows ``r::p`` and every rank runs ``(n // p) // batch_size``
  batches an epoch, the smallest shard's count, so that no rank submits
  a collective its peers will not match;
* **the epoch permutation** ``RandomState(((seed · 1000003 + epoch) ^
  rank) % 2³²)``, the same on every replay of an epoch;
* only full batches (``ValueError`` where a batch exceeds the shard, or
  the arrays disagree on their length);
* ``prefetch`` batches in flight.

On CUDA a batch is gathered into pinned host memory and copied with
``non_blocking=True`` on a side stream; the consuming stream waits on
the copy's event, and every yielded tensor is marked with
``record_stream`` so that the caching allocator does not hand its
memory out again while the consumer still reads it.  Each array keeps
its memory format: an ``(N, C, H, W)`` tensor in ``channels_last`` (an
NHWC host array viewed as NCHW) arrives in ``channels_last``.

Arrays are numpy arrays or CPU torch tensors (bf16 host data comes as a
torch tensor).  One rank drives one device, so the JAX loader's pod mode
(a sharding that spans processes, assembled with
``make_array_from_process_local_data``) has no counterpart: ``device=``
takes the place of ``sharding=``.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator

import numpy as np
import torch

from horovod_tpu_torch import basics

__all__ = ["DataLoader"]


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))


def _memory_format(t: torch.Tensor) -> torch.memory_format:
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
            memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class DataLoader:
    """Iterate a dict of arrays as device-resident minibatches.

    Args:
      arrays: name -> ``(N, ...)`` host arrays (numpy or CPU tensors),
        one N.
      batch_size: the rank's batch size.
      shuffle: reshuffle the rows every epoch (seeded: an epoch's order is
        the same on every replay of the same loader).
      seed: base seed; the rank is folded in, so ranks draw different
        orders and reruns are reproducible.
      shard: take this rank's rows ``r::p`` (default True; pass False when
        the caller already sharded).
      prefetch: batches in flight on the device.
      device: where batches land (CUDA unless ``"cpu"`` is passed).
    """

    def __init__(self, arrays: Dict, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0, shard: bool = True,
                 prefetch: int = 2, device=None) -> None:
        lens = {k: len(v) for k, v in arrays.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"arrays disagree on length: {lens}")
        self.device = basics.resolve_device(device)
        self.n_total = next(iter(lens.values()))
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = max(int(prefetch), 0)
        self._epoch = 0
        arrays = {k: _as_tensor(v) for k, v in arrays.items()}
        if shard and basics.is_initialized() and basics.size() > 1:
            r, p = basics.rank(), basics.size()
            self.arrays = {k: v[r::p] for k, v in arrays.items()}
            # lockstep: every rank yields the smallest shard's count.
            self._len = (self.n_total // p) // self.batch_size
        else:
            self.arrays = arrays
            self._len = self.n_total // self.batch_size
        if self._len == 0:
            raise ValueError(
                f"batch_size={batch_size} exceeds the local shard "
                f"({min(len(v) for v in self.arrays.values())} rows)")
        self._stream = None

    def __len__(self) -> int:
        return self._len

    def _epoch_indices(self) -> np.ndarray:
        n = len(next(iter(self.arrays.values())))
        if not self.shuffle:
            return np.arange(n)
        rank = basics.rank() if basics.is_initialized() else 0
        rng = np.random.RandomState(
            ((self.seed * 1000003 + self._epoch) ^ rank) % (2 ** 32))
        return rng.permutation(n)

    def _host_batch(self, idx: np.ndarray, b: int) -> Dict[str, torch.Tensor]:
        start = b * self.batch_size
        if not self.shuffle:
            # The indices are an arange: a slice, no gather.
            return {k: v[start:start + self.batch_size]
                    for k, v in self.arrays.items()}
        rows = torch.from_numpy(idx[start:start + self.batch_size])
        return {k: v[rows] for k, v in self.arrays.items()}

    def _put(self, host: Dict[str, torch.Tensor]):
        """Start the batch's copy -> (its device tensors, the copy's
        event, None on the CPU)."""
        if self.device.type != "cuda":
            return {k: v.to(self.device, copy=True)
                    for k, v in host.items()}, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        out = {}
        with torch.cuda.stream(self._stream):
            for k, v in host.items():
                fmt = _memory_format(v)
                pinned = torch.empty(v.shape, dtype=v.dtype,
                                     pin_memory=True, memory_format=fmt)
                pinned.copy_(v)
                out[k] = torch.empty_like(pinned, device=self.device)
                out[k].copy_(pinned, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _take(self, pending) -> Dict[str, torch.Tensor]:
        out, event = pending
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in out.values():
                t.record_stream(stream)
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        idx = self._epoch_indices()
        self._epoch += 1
        buf: collections.deque = collections.deque()
        for b in range(min(self.prefetch, self._len)):
            buf.append(self._put(self._host_batch(idx, b)))
        for b in range(self._len):
            nxt = b + self.prefetch
            if nxt < self._len:
                buf.append(self._put(self._host_batch(idx, nxt)))
            yield self._take(buf.popleft())
