"""Collectives over ``torch.distributed``: allreduce with every reduce op,
grouped allreduce, allgather, broadcast, alltoall, reducescatter and
barrier, synchronous and handle-based async.

Counterpart of ``horovod_tpu/ops/collectives.py``, with its op names,
arguments and errors.  A rank is one process driving one device (a JAX
chip), so the JAX package's eager chip weighting is 1 here: ``Sum``
sums one contribution a rank.  Every call is collective: each rank of
the job (:mod:`horovod_tpu_torch.basics`) makes it, in the same order.
The trailing-underscore forms work in place.

* ``prescale_factor`` multiplies before the reduction and
  ``postscale_factor`` after it (also for Adasum, as the JAX eager path
  does); ``compression`` casts for the wire and restores the dtype.
* Hierarchical allreduce (``HOROVOD_HIERARCHICAL_ALLREDUCE``, or
  ``make_train_step(hierarchical=True)``): reduce-scatter in the local group, allreduce of
  the shard in the cross group, allgather in the local group, as
  ``_hier_psum``; hierarchical allgather
  (``HOROVOD_HIERARCHICAL_ALLGATHER``) gathers in the local group, then
  across hosts.  Both need :func:`~horovod_tpu_torch.basics.
  is_homogeneous` (the JAX package's hierarchical mesh exists only
  then); otherwise the flat collective runs.
* The async API (``*_async``, :func:`poll`, :func:`synchronize`) holds
  ``async_op=True`` work objects, each handle used once; the op's
  post-processing (Average's division, the postscale, decompression,
  the concatenation of gathered parts) runs in :func:`synchronize`.
  An op of several dependent collectives (hierarchical, Adasum,
  alltoall with ``splits``) completes when it is submitted.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import adasum

__all__ = ["Adasum", "Average", "Max", "Min", "Product", "Sum", "allgather",
           "allgather_async", "allreduce", "allreduce_", "allreduce_async",
           "alltoall", "alltoall_async", "barrier", "broadcast", "broadcast_",
           "broadcast_async", "grouped_allreduce",
           "hierarchical_allgather_enabled",
           "hierarchical_allreduce_enabled", "poll", "process_sum",
           "reducescatter", "reducescatter_async", "synchronize"]

Average = "Average"
Sum = "Sum"
Adasum = "Adasum"
Min = "Min"
Max = "Max"
Product = "Product"

_REDUCE_OPS = (Average, Sum, Adasum, Min, Max, Product)
_DIST_OPS = {Average: dist.ReduceOp.SUM, Sum: dist.ReduceOp.SUM,
             Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX,
             Product: dist.ReduceOp.PRODUCT}


def _check_op(op: str) -> None:
    if op not in _REDUCE_OPS:
        raise ValueError(f"Unknown reduce op {op!r}; expected one of "
                         f"{_REDUCE_OPS}")


# --- the hierarchical switches ------------------------------------------------

_forced: contextvars.ContextVar = contextvars.ContextVar(
    "hierarchical", default=None)


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "0").lower() not in ("", "0", "false")


def _enabled(kind: str) -> bool:
    forced = _forced.get()
    if forced is not None:
        return forced
    return _env_flag(f"HOROVOD_HIERARCHICAL_{kind.upper()}")


def hierarchical_allreduce_enabled() -> bool:
    """True inside ``_hierarchical(True)``; else as
    ``HOROVOD_HIERARCHICAL_ALLREDUCE`` says."""
    return _enabled("allreduce")


def hierarchical_allgather_enabled() -> bool:
    """True inside ``_hierarchical(True)``; else as
    ``HOROVOD_HIERARCHICAL_ALLGATHER`` says."""
    return _enabled("allgather")


def _use_hierarchical(kind: str) -> bool:
    """Whether an ``"allreduce"`` or ``"allgather"`` runs two-level: its
    switch is on and the job is homogeneous (the JAX package's
    ``(cross, local)`` mesh exists only then)."""
    return _enabled(kind) and basics.is_homogeneous()


@contextlib.contextmanager
def _hierarchical(enabled: bool):
    """Within the block, allreduce and allgather are hierarchical (or
    flat) whatever the environment says: the port's form of the JAX step
    built over the ``(cross, local)`` mesh (``make_train_step``'s
    ``hierarchical``)."""
    token = _forced.set(bool(enabled))
    try:
        yield
    finally:
        _forced.reset(token)


# --- a collective in flight ---------------------------------------------------


class _Pending:
    """A submitted collective: its work object (None once complete) and
    the function that finishes it and returns the result."""

    def __init__(self, work, finish: Callable):
        self.work = work
        self.finish = finish

    def done(self) -> bool:
        return self.work is None or self.work.is_completed()

    def wait(self):
        if self.work is not None:
            self.work.wait()
        return self.finish()


def _done(value) -> _Pending:
    return _Pending(None, lambda: value)


# --- allreduce ----------------------------------------------------------------


def _scale_(t: torch.Tensor, factor) -> torch.Tensor:
    if factor is not None and factor != 1.0:
        t.mul_(factor)
    return t


def _hier_allreduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the job in place, two-level: reduce-scatter in the
    local group, allreduce of the shard in the cross group, allgather
    in the local group; padded to a multiple of the local size."""
    n_local = basics.local_size()
    flat = t.reshape(-1)
    pad = (-flat.numel()) % n_local
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    flat = flat.contiguous()
    shard = flat.new_empty(flat.numel() // n_local)
    dist.reduce_scatter(shard, list(flat.chunk(n_local)),
                        group=basics.local_group())
    dist.all_reduce(shard, group=basics.cross_group())
    full = flat.new_empty(flat.numel())
    dist.all_gather(list(full.chunk(n_local)), shard,
                    group=basics.local_group())
    t.copy_(full[:t.numel()].view(t.shape))
    return t


def _allreduce_start(t: torch.Tensor, op: str, prescale, postscale,
                     async_op: bool) -> _Pending:
    """Reduce ``t`` in place; the result is ``t``."""
    _check_op(op)
    n = basics.size()
    if op == Average and not t.is_floating_point():
        raise TypeError(f"Average needs a floating tensor, got {t.dtype}")
    _scale_(t, prescale)
    if op == Adasum:
        t.copy_(adasum.adasum_allreduce(
            t, hierarchical=_use_hierarchical("allreduce")))
        return _done(_scale_(t, postscale))
    if op in (Average, Sum) and _use_hierarchical("allreduce"):
        _hier_allreduce_(t)
        work = None
    else:
        work = dist.all_reduce(t, op=_DIST_OPS[op], async_op=async_op)

    def finish():
        if op == Average:
            t.div_(n)
        return _scale_(t, postscale)

    return _Pending(work, finish)


def allreduce_(tensor: torch.Tensor, op: str = Average, *,
               prescale_factor: float = 1.0,
               postscale_factor: float = 1.0) -> torch.Tensor:
    """Reduce ``tensor`` over the ranks in place and return it: ``Sum``,
    ``Average`` (the sum over the job's size), ``Min``, ``Max``,
    ``Product`` or ``Adasum``."""
    return _allreduce_start(tensor, op, prescale_factor, postscale_factor,
                            False).wait()


def allreduce(tensor: torch.Tensor, op: str = Average, *, compression=None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """:func:`allreduce_` into a new tensor, compressed on the wire."""
    _check_op(op)
    wire, ctx = _compress(compression, tensor)
    out = allreduce_(wire.clone(), op, prescale_factor=prescale_factor,
                     postscale_factor=postscale_factor)
    return _decompress(compression, out, ctx)


def _compress(compression, tensor):
    if compression is None:
        return tensor, None
    return compression.compress(tensor)


def _decompress(compression, tensor, ctx):
    return tensor if compression is None else compression.decompress(
        tensor, ctx)


def process_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Sum one contribution a process.  A rank is one process driving one
    device, so this is the ``Sum`` allreduce (the JAX package pre-divides
    by the process's chip count, 1 here)."""
    return allreduce(tensor, Sum)


def grouped_allreduce(tensors: Sequence[torch.Tensor], op: str = Average, *,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one fused operation -> new tensors
    in order.  Every op but Adasum reduces through the fusion buckets
    (:mod:`~horovod_tpu_torch.ops.fusion`); Adasum shares its exchange
    rounds across the group and keeps one coefficient per tensor, never
    concatenating a bucket."""
    _check_op(op)
    tensors = [t.clone() for t in tensors]
    for t in tensors:
        _scale_(t, prescale_factor)
    if op == Adasum:
        out = adasum.adasum_allreduce_group(
            tensors, hierarchical=_use_hierarchical("allreduce"))
    else:
        from horovod_tpu_torch.ops import fusion

        out = fusion.fused_allreduce(tensors, op)
    return [_scale_(t, postscale_factor) for t in out]


# --- allgather, broadcast -----------------------------------------------------


def _row_counts(tensor: torch.Tensor) -> List[int]:
    rows = torch.tensor([tensor.shape[0]], device=tensor.device)
    parts = [torch.empty_like(rows) for _ in range(basics.size())]
    dist.all_gather(parts, rows)
    return [int(r) for r in parts]


def _allgather_start(tensor: torch.Tensor, async_op: bool) -> _Pending:
    if tensor.dim() == 0:
        raise ValueError("allgather requires tensors with >= 1 dim")
    n = basics.size()
    counts = _row_counts(tensor)
    padded = tensor.new_zeros((max(counts),) + tuple(tensor.shape[1:]))
    padded[:tensor.shape[0]] = tensor

    def trim(parts):
        return torch.cat([p[:c] for p, c in zip(parts, counts)])

    if _use_hierarchical("allgather"):
        n_local = basics.local_size()
        local = [torch.empty_like(padded) for _ in range(n_local)]
        dist.all_gather(local, padded, group=basics.local_group())
        block = torch.stack(local)
        hosts = [torch.empty_like(block) for _ in range(n // n_local)]
        dist.all_gather(hosts, block, group=basics.cross_group())
        return _done(trim([p for h in hosts for p in h.unbind(0)]))
    parts = [torch.empty_like(padded) for _ in range(n)]
    work = dist.all_gather(parts, padded, async_op=async_op)
    return _Pending(work, lambda: trim(parts))


def allgather(tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along dim 0, in rank order;
    the first dimension may differ between ranks."""
    return _allgather_start(tensor, False).wait()


def _broadcast_start(tensor: torch.Tensor, root_rank: int,
                     async_op: bool) -> _Pending:
    basics.size()  # raises before init
    work = dist.broadcast(tensor, src=root_rank, async_op=async_op)
    return _Pending(work, lambda: tensor)


def broadcast_(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """Overwrite ``tensor`` with ``root_rank``'s, in place."""
    return _broadcast_start(tensor, root_rank, False).wait()


def broadcast(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """:func:`broadcast_` into a new tensor."""
    return broadcast_(tensor.clone(), root_rank)


# --- alltoall, reducescatter --------------------------------------------------


def _alltoall_start(tensor: torch.Tensor, splits, async_op: bool
                    ) -> _Pending:
    P = basics.size()
    if splits is None and tensor.shape[0] % P != 0:
        raise ValueError("alltoall without splits requires dim0 % size == 0")
    if splits is not None:
        splits = [int(s) for s in splits]
        if len(splits) != P or sum(splits) != tensor.shape[0]:
            raise ValueError(f"splits must be ({P},) summing to dim0")
    src = tensor.contiguous()
    if splits is None:
        out = torch.empty_like(src)
        work = dist.all_to_all_single(out, src, async_op=async_op)
        return _Pending(work, lambda: out)
    send = torch.tensor(splits, dtype=torch.int64, device=tensor.device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    counts = recv.tolist()
    out = src.new_empty((sum(counts),) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src, counts, splits)
    return _done(out)


def alltoall(tensor: torch.Tensor, splits=None) -> torch.Tensor:
    """Exchange dim-0 slices: rank ``p`` receives slice ``p`` of every
    rank, in rank order.  ``splits`` (one row count a rank, summing to
    dim 0) sends uneven slices; without it dim 0 splits evenly."""
    return _alltoall_start(tensor, splits, False).wait()


def _validate_reducescatter(tensor: torch.Tensor, op: str) -> None:
    if op not in (Average, Sum):
        raise ValueError("reducescatter supports Sum/Average")
    P = basics.size() if basics.is_initialized() else 1
    if tensor.dim() == 0:
        raise ValueError("reducescatter requires tensors with >= 1 dim")
    if tensor.shape[0] % max(P, 1) != 0:
        raise ValueError(
            f"reducescatter requires dim0 ({tensor.shape[0]}) divisible by "
            f"the worker count ({P})")


def _reducescatter_start(tensor: torch.Tensor, op: str, async_op: bool
                         ) -> _Pending:
    _validate_reducescatter(tensor, op)
    P = basics.size()
    ins = list(tensor.contiguous().chunk(P))
    out = torch.empty_like(ins[0])
    work = dist.reduce_scatter(out, ins, async_op=async_op)

    def finish():
        return out.div_(P) if op == Average else out

    return _Pending(work, finish)


def reducescatter(tensor: torch.Tensor, op: str = Average) -> torch.Tensor:
    """Reduce over the ranks, then rank ``p`` keeps dim-0 slice ``p``."""
    return _reducescatter_start(tensor, op, False).wait()


def barrier() -> None:
    """Return once every rank has called it."""
    basics.size()
    dist.barrier()


# --- the async API ------------------------------------------------------------


class _HandleManager:
    """Integer handles of collectives in flight; each is taken once."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 0
        self._pending: dict = {}

    def allocate(self, pending: _Pending) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._pending[h] = pending
            return h

    def take(self, handle: int) -> _Pending:
        with self._lock:
            if handle not in self._pending:
                raise ValueError(
                    f"Unknown or already-synchronized handle {handle}")
            return self._pending.pop(handle)

    def peek(self, handle: int) -> Optional[_Pending]:
        with self._lock:
            return self._pending.get(handle)


_handles = _HandleManager()


def allreduce_async(tensor: torch.Tensor, op: str = Average, *,
                    compression=None, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> int:
    """Start :func:`allreduce` -> a handle for :func:`synchronize`."""
    _check_op(op)
    wire, ctx = _compress(compression, tensor)
    p = _allreduce_start(wire.clone(), op, prescale_factor, postscale_factor,
                         True)
    finish = p.finish
    p.finish = lambda: _decompress(compression, finish(), ctx)
    return _handles.allocate(p)


def allgather_async(tensor: torch.Tensor) -> int:
    return _handles.allocate(_allgather_start(tensor, True))


def broadcast_async(tensor: torch.Tensor, root_rank: int = 0) -> int:
    return _handles.allocate(_broadcast_start(tensor.clone(), root_rank,
                                              True))


def reducescatter_async(tensor: torch.Tensor, op: str = Average) -> int:
    return _handles.allocate(_reducescatter_start(tensor, op, True))


def alltoall_async(tensor: torch.Tensor, splits=None) -> int:
    return _handles.allocate(_alltoall_start(tensor, splits, True))


def poll(handle: int) -> bool:
    """True if the op behind ``handle`` has completed (or was already
    synchronized)."""
    p = _handles.peek(handle)
    return p is None or p.done()


def synchronize(handle: int):
    """Wait for the op behind ``handle`` and return its result; the
    handle is spent."""
    return _handles.take(handle).wait()
