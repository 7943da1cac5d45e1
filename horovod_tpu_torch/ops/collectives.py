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
* Adasum at a job size that is not a power of two: the eager calls
  gather and reduce serially (the JAX eager fallback); inside
  :func:`_direct_path` and over an ``axis_name`` it raises, as JAX's
  in-graph ``adasum_allreduce`` does.
* ``axis_name`` (every collective but the ``*_async`` forms and the
  barrier) is JAX's in-graph form, run directly, never through the
  eager runtime: the ranks of one axis or a tuple of axes
  (:func:`_axis_group`): an axis of the bound mesh or a tuple of its
  axes, in JAX's order for the tuple (the first axis outermost); the
  local or the cross group; the world for the flat name
  (:func:`~horovod_tpu_torch.basics.axis_name`) and ``(cross,
  local)``.  allgather's blocks, broadcast's ``root_rank`` (an index
  along the axes) and Adasum's pairing follow that order; alltoall and
  reducescatter take one axis only; Adasum over a pair averages over
  the second axis, then combines over the first, whatever the
  hierarchical switch says: the switch chooses the form only without an
  ``axis_name``.
* The async API (``*_async``, :func:`poll`, :func:`synchronize`) holds
  ``async_op=True`` work objects, each handle used once; the op's
  post-processing (Average's division, the postscale, decompression,
  the concatenation of gathered parts) runs in :func:`synchronize`.
  An op of several dependent collectives (hierarchical, Adasum,
  alltoall with ``splits``) completes when it is submitted.
* While the native runtime is up (:mod:`~horovod_tpu_torch.
  eager_runtime`, started by ``basics.init`` unless ``HOROVOD_NATIVE=0``)
  every eager call is a named request (``name=``, else
  ``<kind>.noname.<n>``), negotiated across ranks and fused, as the JAX
  package's eager path is; its handles hold native handles (``poll`` is
  ``hvd_poll``).  Calls of the training step stay direct (see
  :func:`_native_rt`).
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
           "allreduce_async_", "alltoall", "alltoall_async", "barrier",
           "broadcast", "broadcast_", "broadcast_async", "broadcast_async_",
           "grouped_allreduce",
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


# --- native-runtime routing ---------------------------------------------------
#
# When the native control plane (horovod_tpu_torch.native, run by
# eager_runtime) is up, every eager op is enqueued as a named request and
# executed only once the coordinator declares it globally ready; requests
# submitted in the same cycle fuse into one collective.  Without it
# (HOROVOD_NATIVE=0), ops run directly in program order.  As in the JAX
# package, where only eager calls route and in-graph ones never do, the
# training step's collectives stay direct: a call inside _direct_path()
# (spmd.TrainStep, the optimizers' step, masked_average), inside
# _hierarchical() (the step's own switch), or while a CUDA graph is
# capturing on this thread (a background thread cannot launch into a
# capture).

_direct: contextvars.ContextVar = contextvars.ContextVar(
    "direct", default=False)


@contextlib.contextmanager
def _direct_path():
    """Within the block, collectives run directly, never through the
    native runtime (the port's counterpart of JAX's in-graph calls)."""
    token = _direct.set(True)
    try:
        yield
    finally:
        _direct.reset(token)


def _native_rt():
    """The eager runtime, or None where the call runs directly."""
    if _direct.get() or _forced.get() is not None:
        return None
    from horovod_tpu_torch import eager_runtime

    rt = eager_runtime.get()
    if rt is not None and torch.cuda.is_available() \
            and torch.cuda.is_current_stream_capturing():
        return None
    return rt


def _native_kind(kind: str) -> int:
    from horovod_tpu_torch import native

    return {
        "allreduce": native.ALLREDUCE,
        "allgather": native.ALLGATHER,
        "broadcast": native.BROADCAST,
        "alltoall": native.ALLTOALL,
        "reducescatter": native.REDUCESCATTER,
    }[kind]


def _native_reduce_op(op: str) -> int:
    from horovod_tpu_torch import eager_runtime

    to_native, _ = eager_runtime._op_maps()
    return to_native[op]


def _native_submit(rt, kind: str, tensors: Sequence[torch.Tensor], name,
                   **kw) -> list:
    """Submit every tensor as its own named request -> [(handle, name)].
    All go in before any wait, so one negotiation cycle sees — and
    fuses — the whole group."""
    op_type = _native_kind(kind)
    pairs = []
    for i, t in enumerate(tensors):
        lname = rt.auto_name(kind, f"{name}.{i}" if name and len(tensors) > 1
                             else name)
        pairs.append((rt.submit(lname, op_type, t, **kw), lname))
    return pairs


class _NativePending:
    """Ops pending in the native runtime's negotiation queue (the
    reference's handle, ``torch/mpi_ops_v2.cc`` + ``handle_manager.cc:
    21-55``); ``finish`` maps the list of results to the op's result."""

    def __init__(self, rt, pairs, finish: Callable):
        self.rt = rt
        self.pairs = pairs
        self.finish = finish

    def done(self) -> bool:
        return all(self.rt.poll(h) for h, _ in self.pairs)

    def wait(self):
        return self.finish([self.rt.wait(h, n) for h, n in self.pairs])


def _native_allreduce(rt, tensors, op, name, prescale, postscale,
                      finish: Callable) -> _NativePending:
    for t in tensors:
        _check_allreduce(t, op)
    pairs = _native_submit(
        rt, "allreduce", tensors, name, reduce_op=_native_reduce_op(op),
        prescale=1.0 if prescale is None else float(prescale),
        postscale=1.0 if postscale is None else float(postscale))
    return _NativePending(rt, pairs, finish)


def _first(outs):
    return outs[0]


def _into(tensor: torch.Tensor, inplace: bool) -> Callable:
    """The finish of a one-tensor op: its result, or (in place) the result
    copied into ``tensor``."""
    return (lambda outs: tensor.copy_(outs[0])) if inplace else _first


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


def _check_allreduce(t: torch.Tensor, op: str) -> None:
    _check_op(op)
    if op == Average and not t.is_floating_point():
        raise TypeError(f"Average needs a floating tensor, got {t.dtype}")


def _allreduce_start(t: torch.Tensor, op: str, prescale, postscale,
                     async_op: bool, ax=None) -> _Pending:
    """Reduce ``t`` in place over ``ax`` (:func:`_axis_group`; default
    the world); the result is ``t``.  Adasum here is the world's, whose
    form the hierarchical switch chooses (an explicit ``axis_name``'s
    runs through :func:`adasum.adasum_allreduce_group`)."""
    _check_allreduce(t, op)
    ax = _world() if ax is None else ax
    _scale_(t, prescale)
    if op == Adasum:
        t.copy_(_adasum_group([t], ax.group)[0])
        return _done(_scale_(t, postscale))
    if op in (Average, Sum) and ax.world and _use_hierarchical("allreduce"):
        _hier_allreduce_(t)
        work = None
    else:
        work = dist.all_reduce(t, op=_DIST_OPS[op], group=ax.group,
                               async_op=async_op)

    def finish():
        if op == Average:
            t.div_(ax.size)
        return _scale_(t, postscale)

    return _Pending(work, finish)


def _adasum_group(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Adasum over the job (``group``: a process group of every rank, or
    None for the world), two-level where the hierarchical switch says:
    in-graph inside :func:`_direct_path` (a size that is not a power of
    two raises, as JAX's ``adasum_allreduce`` does), else eager (gathered
    and reduced serially at such a size, as JAX's eager Adasum is)."""
    return adasum.adasum_allreduce_group(
        tensors, hierarchical=_use_hierarchical("allreduce"), group=group,
        eager=not _direct.get())


def _names(axis_name) -> tuple:
    return (tuple(axis_name) if isinstance(axis_name, (tuple, list))
            else (axis_name,))


def _world(group=None):
    """The job's own axis: every rank, in rank order, over ``group``
    (default the world's; the eager runtime passes its own)."""
    from horovod_tpu_torch.parallel import meshes

    ctx = basics._ctx()
    return meshes.Axes(group, tuple(range(ctx.size)), ctx.rank, world=True)


def _axis_group(axis_name):
    """``axis_name`` resolved on this rank, as the JAX package resolves
    an ``axis_name`` to the axes it reduces over -> a
    :class:`~horovod_tpu_torch.parallel.meshes.Axes` (its process group,
    its ranks in JAX's order, this rank's index): the job's world for
    None, the flat name (:func:`~horovod_tpu_torch.basics.axis_name`)
    and the pair ``(cross, local)``; the local or the cross group for
    those names; else an axis or a tuple of axes of the bound mesh
    (:func:`~horovod_tpu_torch.parallel.meshes.axes_group`;
    ``NameError`` naming an unbound axis)."""
    from horovod_tpu_torch.parallel import meshes

    ctx = basics._ctx()
    names = _names(axis_name)
    if names in ((None,), (ctx.axis_name,),
                 (basics.CROSS_AXIS, basics.LOCAL_AXIS)):
        return _world()
    if names == (basics.LOCAL_AXIS,):
        return meshes.Axes(ctx.local_group, ctx.local_ranks,
                           ctx.local_ranks.index(ctx.rank))
    if names == (basics.CROSS_AXIS,):
        return meshes.Axes(ctx.cross_group, ctx.cross_ranks,
                           ctx.cross_ranks.index(ctx.rank))
    return meshes.axes_group(names)


def _allreduce_pending(tensor: torch.Tensor, op: str, name, prescale,
                       postscale, async_op: bool, inplace: bool,
                       axis_name=None):
    """Reduce ``tensor`` (in place when ``inplace``, else into a new
    tensor): through the runtime, or directly.  An explicit
    ``axis_name`` is JAX's in-graph form, direct (the runtime negotiates
    over the world), its Adasum :func:`adasum.adasum_allreduce_group`'s
    axis form whatever the hierarchical switch says."""
    if axis_name is not None:
        t = tensor if inplace else tensor.clone()
        with _direct_path():
            if op != Adasum:
                return _allreduce_start(t, op, prescale, postscale,
                                        async_op, _axis_group(axis_name))
            _check_allreduce(t, op)
            _scale_(t, prescale)
            t.copy_(adasum.adasum_allreduce_group(
                [t], axis_name=axis_name)[0])
            return _done(_scale_(t, postscale))
    rt = _native_rt()
    if rt is None:
        return _allreduce_start(tensor if inplace else tensor.clone(), op,
                                prescale, postscale, async_op)
    return _native_allreduce(rt, [tensor], op, name, prescale, postscale,
                             _into(tensor, inplace))


def allreduce_(tensor: torch.Tensor, op: str = Average, *, axis_name=None,
               name: Optional[str] = None, prescale_factor: float = 1.0,
               postscale_factor: float = 1.0) -> torch.Tensor:
    """Reduce ``tensor`` over the ranks in place and return it: ``Sum``,
    ``Average`` (the sum over the job's size), ``Min``, ``Max``,
    ``Product`` or ``Adasum``.  ``axis_name``: over that axis's or
    tuple of axes' ranks only (:func:`_axis_group`; ``Average`` divides
    by its size; Adasum as :func:`adasum.adasum_allreduce`'s)."""
    return _allreduce_pending(tensor, op, name, prescale_factor,
                              postscale_factor, False, True,
                              axis_name).wait()


def allreduce(tensor: torch.Tensor, op: str = Average, *, axis_name=None,
              compression=None, name: Optional[str] = None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """:func:`allreduce_` into a new tensor, compressed on the wire."""
    _check_op(op)
    wire, ctx = _compress(compression, tensor)
    out = _allreduce_pending(wire, op, name, prescale_factor,
                             postscale_factor, False, False,
                             axis_name).wait()
    return _decompress(compression, out, ctx)


def _compress(compression, tensor):
    if compression is None:
        return tensor, None
    return compression.compress(tensor)


def _decompress(compression, tensor, ctx):
    return tensor if compression is None else compression.decompress(
        tensor, ctx)


def process_sum(tensor: torch.Tensor, *,
                name: Optional[str] = None) -> torch.Tensor:
    """Sum one contribution a process.  A rank is one process driving one
    device, so this is the ``Sum`` allreduce (the JAX package pre-divides
    by the process's chip count, 1 here)."""
    return allreduce(tensor, Sum, name=name)


def grouped_allreduce(tensors: Sequence[torch.Tensor], op: str = Average, *,
                      axis_name=None, name: Optional[str] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one fused operation -> new tensors
    in order.  Through the runtime, the whole group is submitted before
    any wait, so the controller fuses it by its threshold.  Directly,
    every op but Adasum reduces through the fusion buckets
    (:mod:`~horovod_tpu_torch.ops.fusion`); Adasum shares its exchange
    rounds across the group and keeps one coefficient per tensor, never
    concatenating a bucket.  ``axis_name``: over that axis's or tuple of
    axes' ranks (as :func:`allreduce`'s), directly."""
    _check_op(op)
    tensors = list(tensors)
    rt = _native_rt() if axis_name is None else None
    if rt is not None:
        return _native_allreduce(rt, tensors, op, name, prescale_factor,
                                 postscale_factor, list).wait()
    tensors = [t.clone() for t in tensors]
    for t in tensors:
        _scale_(t, prescale_factor)
    if op == Adasum and axis_name is None:
        out = _adasum_group(tensors, None)
    else:
        from horovod_tpu_torch.ops import fusion

        with _direct_path():
            out = (adasum.adasum_allreduce_group(tensors,
                                                 axis_name=axis_name)
                   if op == Adasum else
                   fusion.fused_allreduce(tensors, op, axis_name=axis_name))
    return [_scale_(t, postscale_factor) for t in out]


# --- allgather, broadcast -----------------------------------------------------


def _row_counts(tensor: torch.Tensor, ax) -> List[int]:
    """Every rank's dim 0 along ``ax``, in JAX's order."""
    rows = torch.tensor([tensor.shape[0]], device=tensor.device)
    parts = [torch.empty_like(rows) for _ in range(ax.size)]
    dist.all_gather(parts, rows, group=ax.group)
    return [int(r) for r in ax.to_jax_order(parts)]


def _check_allgather(tensor: torch.Tensor) -> None:
    if tensor.dim() == 0:
        raise ValueError("allgather requires tensors with >= 1 dim")


def _allgather_start(tensor: torch.Tensor, async_op: bool,
                     ax=None) -> _Pending:
    _check_allgather(tensor)
    ax = _world() if ax is None else ax
    n = ax.size
    counts = _row_counts(tensor, ax)
    padded = tensor.new_zeros((max(counts),) + tuple(tensor.shape[1:]))
    padded[:tensor.shape[0]] = tensor

    def trim(parts):
        return torch.cat([p[:c] for p, c in zip(parts, counts)])

    if ax.world and _use_hierarchical("allgather"):
        n_local = basics.local_size()
        local = [torch.empty_like(padded) for _ in range(n_local)]
        dist.all_gather(local, padded, group=basics.local_group())
        block = torch.stack(local)
        hosts = [torch.empty_like(block) for _ in range(n // n_local)]
        dist.all_gather(hosts, block, group=basics.cross_group())
        return _done(trim([p for h in hosts for p in h.unbind(0)]))
    parts = [torch.empty_like(padded) for _ in range(n)]
    work = dist.all_gather(parts, padded, group=ax.group, async_op=async_op)
    return _Pending(work, lambda: trim(ax.to_jax_order(parts)))


def _allgather_pending(tensor: torch.Tensor, name, async_op: bool,
                       axis_name=None):
    rt = _native_rt() if axis_name is None else None
    if rt is None:
        return _allgather_start(tensor, async_op, _axis_group(axis_name))
    _check_allgather(tensor)
    return _NativePending(rt, _native_submit(rt, "allgather", [tensor],
                                             name), _first)


def allgather(tensor: torch.Tensor, *, axis_name=None,
              name: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along dim 0, in rank order;
    the first dimension may differ between ranks.  ``axis_name``: the
    ranks of that axis or tuple of axes, in JAX's order for it (the
    first axis outermost), directly."""
    return _allgather_pending(tensor, name, False, axis_name).wait()


def _broadcast_start(tensor: torch.Tensor, root_rank: int,
                     async_op: bool, ax=None) -> _Pending:
    """``root_rank``: an index along ``ax`` (default the world, where it
    is the global rank)."""
    ax = _world() if ax is None else ax
    work = dist.broadcast(tensor, src=ax.ranks[root_rank], group=ax.group,
                          async_op=async_op)
    return _Pending(work, lambda: tensor)


def _broadcast_pending(tensor: torch.Tensor, root_rank: int, name,
                       async_op: bool, inplace: bool, axis_name=None):
    rt = _native_rt() if axis_name is None else None
    if rt is None:
        return _broadcast_start(tensor if inplace else tensor.clone(),
                                root_rank, async_op, _axis_group(axis_name))
    return _NativePending(rt, _native_submit(
        rt, "broadcast", [tensor], name, root_rank=root_rank),
        _into(tensor, inplace))


def broadcast_(tensor: torch.Tensor, root_rank: int = 0, *, axis_name=None,
               name: Optional[str] = None) -> torch.Tensor:
    """Overwrite ``tensor`` with ``root_rank``'s, in place.
    ``axis_name``: among the ranks of that axis or tuple of axes, where
    ``root_rank`` is the index along it in JAX's order (the masked psum
    of JAX's in-graph broadcast), directly."""
    return _broadcast_pending(tensor, root_rank, name, False, True,
                              axis_name).wait()


def broadcast(tensor: torch.Tensor, root_rank: int = 0, *, axis_name=None,
              name: Optional[str] = None) -> torch.Tensor:
    """:func:`broadcast_` into a new tensor."""
    return _broadcast_pending(tensor, root_rank, name, False, False,
                              axis_name).wait()


# --- alltoall, reducescatter --------------------------------------------------


def _single_axis(axis_name, kind: str):
    """The one axis of ``alltoall`` and ``reducescatter`` (None: the
    world); a tuple of several raises JAX's text."""
    if axis_name is None:
        return None
    if len(_names(axis_name)) != 1:
        raise ValueError(f"{kind} supports a single mesh axis")
    return _axis_group(axis_name)


def _check_alltoall(tensor: torch.Tensor, splits,
                    n: Optional[int] = None) -> Optional[List[int]]:
    P = basics.size() if n is None else n
    if splits is None and tensor.shape[0] % P != 0:
        raise ValueError("alltoall without splits requires dim0 % size == 0")
    if splits is not None:
        splits = [int(s) for s in splits]
        if len(splits) != P or sum(splits) != tensor.shape[0]:
            raise ValueError(f"splits must be ({P},) summing to dim0")
    return splits


def _alltoall_start(tensor: torch.Tensor, splits, async_op: bool,
                    ax=None) -> _Pending:
    """Slice ``j`` (in JAX's order along ``ax``) goes to the rank of
    index ``j``; the received slices come back in that order."""
    ax = _world() if ax is None else ax
    splits = _check_alltoall(tensor, splits, ax.size)
    src = tensor.contiguous()
    if splits is None:
        if ax.perm is not None:
            src = torch.cat(ax.to_group_order(list(src.chunk(ax.size))))
        out = torch.empty_like(src)
        work = dist.all_to_all_single(out, src, group=ax.group,
                                      async_op=async_op)
        if ax.perm is None:
            return _Pending(work, lambda: out)
        return _Pending(work, lambda: torch.cat(ax.to_jax_order(
            list(out.chunk(ax.size)))))
    pieces = ax.to_group_order(list(src.split(splits)))
    sends = [p.shape[0] for p in pieces]
    send = torch.tensor(sends, dtype=torch.int64, device=tensor.device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    counts = recv.tolist()
    out = src.new_empty((sum(counts),) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src if ax.perm is None else
                           torch.cat(pieces), counts, sends, group=ax.group)
    if ax.perm is not None:
        out = torch.cat(ax.to_jax_order(list(out.split(counts))))
    return _done(out)


def _alltoall_pending(tensor: torch.Tensor, splits, name, async_op: bool,
                      axis_name=None):
    ax = _single_axis(axis_name, "alltoall")
    if ax is not None:
        return _alltoall_start(tensor, splits, async_op, ax)
    rt = _native_rt()
    if rt is not None:
        _check_alltoall(tensor, splits)
        if splits is None:
            return _NativePending(rt, _native_submit(rt, "alltoall",
                                                     [tensor], name), _first)
        # Uneven splits can't ride the native queue (the wire Request has
        # no splits field, matching the reference v0.19 op set which
        # predates alltoallv), so they run on the direct path.  Flush with
        # a native BARRIER first: every op submitted before this point (on
        # any rank) completes before the barrier does, and the barrier is
        # dispatched last in its cycle, so no negotiated launch can
        # interleave with the direct collective (protocol invariant #4).
        rt.barrier()
    return _alltoall_start(tensor, splits, async_op)


def alltoall(tensor: torch.Tensor, splits=None, *, axis_name=None,
             name: Optional[str] = None) -> torch.Tensor:
    """Exchange dim-0 slices: rank ``p`` receives slice ``p`` of every
    rank, in rank order.  ``splits`` (one row count a rank, summing to
    dim 0) sends uneven slices; without it dim 0 splits evenly.
    ``axis_name``: among one axis's ranks, in its order, directly; a
    tuple of several axes raises, as JAX's does."""
    return _alltoall_pending(tensor, splits, name, False, axis_name).wait()


def _validate_reducescatter(tensor: torch.Tensor, op: str,
                            n: Optional[int] = None) -> None:
    if op not in (Average, Sum):
        raise ValueError("reducescatter supports Sum/Average")
    P = n if n is not None else (
        basics.size() if basics.is_initialized() else 1)
    if tensor.dim() == 0:
        raise ValueError("reducescatter requires tensors with >= 1 dim")
    if tensor.shape[0] % max(P, 1) != 0:
        raise ValueError(
            f"reducescatter requires dim0 ({tensor.shape[0]}) divisible by "
            f"the worker count ({P})")


def _reducescatter_start(tensor: torch.Tensor, op: str, async_op: bool,
                         ax=None) -> _Pending:
    """Reduce over ``ax``'s ranks; the rank of index ``j`` along it keeps
    dim-0 slice ``j``; ``Average`` divides by its size."""
    _validate_reducescatter(tensor, op, None if ax is None else ax.size)
    ax = _world() if ax is None else ax
    P = ax.size
    ins = ax.to_group_order(list(tensor.contiguous().chunk(P)))
    out = torch.empty_like(ins[0])
    work = dist.reduce_scatter(out, ins, group=ax.group, async_op=async_op)

    def finish():
        return out.div_(P) if op == Average else out

    return _Pending(work, finish)


def _reducescatter_pending(tensor: torch.Tensor, op: str, name,
                           async_op: bool, axis_name=None):
    ax = _single_axis(axis_name, "reducescatter")
    if ax is not None:
        return _reducescatter_start(tensor, op, async_op, ax)
    rt = _native_rt()
    if rt is None:
        return _reducescatter_start(tensor, op, async_op)
    _validate_reducescatter(tensor, op)
    return _NativePending(rt, _native_submit(
        rt, "reducescatter", [tensor], name,
        reduce_op=_native_reduce_op(op)), _first)


def reducescatter(tensor: torch.Tensor, op: str = Average, *,
                  axis_name=None,
                  name: Optional[str] = None) -> torch.Tensor:
    """Reduce over the ranks, then rank ``p`` keeps dim-0 slice ``p``.
    ``axis_name``: over one axis's ranks, the rank of index ``j`` along
    it keeping slice ``j``, directly; a tuple of several axes raises, as
    JAX's does."""
    return _reducescatter_pending(tensor, op, name, False,
                                  axis_name).wait()


def barrier() -> None:
    """Return once every rank has called it: a native BARRIER request
    through the coordinator while the runtime is up, else
    ``dist.barrier``."""
    basics.size()
    rt = _native_rt()
    if rt is not None:
        rt.barrier()
        return
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
                    name: Optional[str] = None, compression=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> int:
    """Start :func:`allreduce` -> a handle for :func:`synchronize`."""
    _check_op(op)
    wire, ctx = _compress(compression, tensor)
    p = _allreduce_pending(wire, op, name, prescale_factor, postscale_factor,
                           True, False)
    finish = p.finish
    p.finish = lambda *a: _decompress(compression, finish(*a), ctx)
    return _handles.allocate(p)


def allreduce_async_(tensor: torch.Tensor, op: str = Average, *,
                     name: Optional[str] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0) -> int:
    """Start :func:`allreduce_` (in place): :func:`synchronize` returns
    ``tensor`` holding the result."""
    return _handles.allocate(_allreduce_pending(
        tensor, op, name, prescale_factor, postscale_factor, True, True))


def allgather_async(tensor: torch.Tensor, *,
                    name: Optional[str] = None) -> int:
    return _handles.allocate(_allgather_pending(tensor, name, True))


def broadcast_async(tensor: torch.Tensor, root_rank: int = 0, *,
                    name: Optional[str] = None) -> int:
    return _handles.allocate(_broadcast_pending(tensor, root_rank, name,
                                                True, False))


def broadcast_async_(tensor: torch.Tensor, root_rank: int = 0, *,
                     name: Optional[str] = None) -> int:
    """Start :func:`broadcast_` (in place): :func:`synchronize` returns
    ``tensor`` holding ``root_rank``'s values."""
    return _handles.allocate(_broadcast_pending(tensor, root_rank, name,
                                                True, True))


def reducescatter_async(tensor: torch.Tensor, op: str = Average, *,
                        name: Optional[str] = None) -> int:
    return _handles.allocate(_reducescatter_pending(tensor, op, name, True))


def alltoall_async(tensor: torch.Tensor, splits=None, *,
                   name: Optional[str] = None) -> int:
    return _handles.allocate(_alltoall_pending(tensor, splits, name, True))


def poll(handle: int) -> bool:
    """True if the op behind ``handle`` has completed (or was already
    synchronized)."""
    p = _handles.peek(handle)
    return p is None or p.done()


def synchronize(handle: int):
    """Wait for the op behind ``handle`` and return its result; the
    handle is spent."""
    return _handles.take(handle).wait()
