"""Adasum: scale-insensitive gradient reduction over ``torch.distributed``.

Counterpart of ``horovod_tpu/ops/adasum.py``.  The pairwise combination

    a' = (1 - a.b / (2 |a|^2)) * a  +  (1 - a.b / (2 |b|^2)) * b

(zero-norm guards: a zero tensor's coefficient is 1; dot products in
f32) is applied over the recursive exchange of ``_adasum_over_axis``: at
level ``k`` each rank swaps its tensor with the rank ``rank ^ 2^k`` of
its group (``dist.batch_isend_irecv``, both directions posted together,
so no pair waits on the other) and both compute the pair's combination
with the lower rank as ``a``, so after log2(P) levels every rank holds
the same result; at size 1 it is the identity.  The hierarchical form
averages over the local group, then runs Adasum over the cross group.

An ``axis_name`` is JAX's in-graph ``adasum_allreduce(axis_name=)``,
whatever the hierarchical switch says: one axis (a mesh axis of the
bound mesh, or one of ``basics``' flat names) runs the exchange over
its ranks in its order; a pair ``(A, B)`` averages over ``B``, then
runs Adasum over ``A`` (``(cross, local)``: the hierarchical form);
more axes raise JAX's text.

At a group size that is not a power of two the in-graph forms (the calls
of the training step and an ``axis_name``'s group) raise, as JAX's
``adasum_allreduce`` does.  The eager entry points (the eager
``allreduce(op=Adasum)``, ``grouped_allreduce`` and the native runtime's
fused Adasum group, :func:`adasum_allreduce_group` with ``eager``) take
the JAX package's fallback there: every rank's tensor is gathered and
reduced by :func:`adasum_reduce_stack`, the serial recursion (the JAX
``eager_adasum_group`` / ``eager_adasum``).  At odd P that recursion
pairs the last row with a broadcast partner, so one rank's tensor
counts twice: at P = 3 it is ada(ada(x0, x1), ada(x2, x1)).  The port
keeps JAX's result (ROADMAP, Queue 3).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics

__all__ = ["adasum_allreduce", "adasum_allreduce_group",
           "adasum_reduce_stack"]


def _pairwise(a, b, dot, asq, bsq):
    """One Adasum combination with the reference's coefficients and
    zero-norm guards."""
    one = torch.ones((), dtype=torch.float32, device=a.device)
    acoef = torch.where(asq > 0, one - dot / (2.0 * asq), one)
    bcoef = torch.where(bsq > 0, one - dot / (2.0 * bsq), one)
    return acoef.to(a.dtype) * a + bcoef.to(b.dtype) * b


def _leaf_dots(a, b):
    a32 = a.float().reshape(-1)
    b32 = b.float().reshape(-1)
    return torch.dot(a32, b32), torch.dot(a32, a32), torch.dot(b32, b32)


def _power_of_two(n: int) -> bool:
    return n & (n - 1) == 0


def _check_size(n: int) -> None:
    if not _power_of_two(n):
        raise ValueError(
            f"Adasum requires a power-of-two axis size (got {n}); the "
            "reference has the same restriction (adasum_gpu_operations.cc)")


def _adasum_over(tensors: List[torch.Tensor], ranks: Sequence[int],
                 group) -> List[torch.Tensor]:
    """The recursive exchange over the ranks ``ranks`` of ``group`` (this
    rank among them) -> new tensors, one coefficient pair per tensor."""
    n = len(ranks)
    _check_size(n)
    out = [t.contiguous().clone() for t in tensors]
    idx = ranks.index(basics.rank())
    stride = 1
    while stride < n:
        peer = ranks[idx ^ stride]
        theirs = [torch.empty_like(t) for t in out]
        ops = []
        for mine, recv in zip(out, theirs):
            ops.append(dist.P2POp(dist.isend, mine, peer, group))
            ops.append(dist.P2POp(dist.irecv, recv, peer, group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        lower = (idx & stride) == 0
        combined = []
        for mine, recv in zip(out, theirs):
            a, b = (mine, recv) if lower else (recv, mine)
            combined.append(_pairwise(a, b, *_leaf_dots(a, b)))
        out = combined
        stride <<= 1
    return out


def _mean(tensors: List[torch.Tensor], group,
          n: int) -> List[torch.Tensor]:
    """Each tensor averaged over the ``n`` ranks of ``group`` (new
    tensors)."""
    out = []
    for t in tensors:
        t = t.contiguous().clone()
        dist.all_reduce(t, group=group)
        out.append(t.div_(n))
    return out


def _axis_form(tensors: List[torch.Tensor],
               axis_name) -> List[torch.Tensor]:
    """JAX's in-graph ``adasum_allreduce`` over ``axis_name``: the mean
    over a pair's second axis first, then the exchange over the (first)
    axis's ranks in JAX's order; a size that is not a power of two
    raises."""
    from horovod_tpu_torch.ops import collectives as C

    names = C._names(axis_name)
    if len(names) == 2:
        inner = C._axis_group(names[1])
        tensors = _mean(tensors, inner.group, inner.size)
        names = names[:1]
    elif len(names) != 1:
        raise ValueError("adasum_allreduce takes one axis or (cross, local)")
    ax = C._axis_group(names[0])
    _check_size(ax.size)
    return _adasum_over(tensors, list(ax.ranks), ax.group)


def _gathered(tensors: List[torch.Tensor], group,
              n: int) -> List[torch.Tensor]:
    """The fallback at a size that is not a power of two: each tensor
    gathered from the ``n`` ranks of ``group`` (in their order) and
    reduced by the serial recursion, the same result on every rank."""
    out = []
    for t in tensors:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        out.append(adasum_reduce_stack(torch.stack(parts)))
    return out


def adasum_allreduce_group(tensors: Sequence[torch.Tensor], *,
                           axis_name=None, hierarchical: bool = False,
                           group=None,
                           eager: bool = False) -> List[torch.Tensor]:
    """Adasum of a group of tensors: the log2(P) exchange rounds are
    shared, each tensor keeps its own coefficients (the JAX
    ``eager_adasum_group``).  ``hierarchical`` (on a homogeneous job, as
    the collectives decide it) first averages over the local group, then
    combines across hosts: the JAX form over ``(cross, local)``.  The
    flat exchange runs over ``group`` (a process group of every rank;
    default the world), the eager runtime's own when it executes.

    At a size that is not a power of two the in-graph form raises, as
    JAX's ``adasum_allreduce`` does; with ``eager`` (the eager entry
    points) every rank's tensor is gathered and reduced by
    :func:`adasum_reduce_stack`, per tensor (the JAX
    ``eager_adasum_group`` / ``eager_adasum``).

    ``axis_name`` (not None) takes the axis form of the module's
    docstring instead; ``hierarchical``, ``group`` and ``eager`` are then
    not read."""
    tensors = list(tensors)
    if axis_name is not None:
        return _axis_form(tensors, axis_name)
    ctx = basics._ctx()
    if hierarchical:
        ranks, group = list(ctx.cross_ranks), ctx.cross_group
    else:
        ranks = list(range(ctx.size))
    if not eager:
        _check_size(len(ranks))
    if hierarchical:
        tensors = _mean(tensors, ctx.local_group, ctx.local_size)
    if _power_of_two(len(ranks)):
        return _adasum_over(tensors, ranks, group)
    return _gathered(tensors, group, len(ranks))


def adasum_allreduce(tensor: torch.Tensor, *, axis_name=None,
                     hierarchical: bool = False) -> torch.Tensor:
    """Adasum of one tensor -> a new tensor, equal on every rank of the
    reduction: over the job (two-level with ``hierarchical``), or over
    ``axis_name``: one axis, or a pair ``(A, B)`` (the mean over ``B``,
    then Adasum over ``A``), as JAX's ``adasum_allreduce`` (see
    :func:`adasum_allreduce_group`)."""
    return adasum_allreduce_group([tensor], axis_name=axis_name,
                                  hierarchical=hierarchical)[0]


def adasum_reduce_stack(stacked: torch.Tensor) -> torch.Tensor:
    """Serial oracle: Adasum of a stacked ``(P, ...)`` tensor with the
    distributed recursion's pairing order."""
    x = stacked
    while x.shape[0] > 1:
        a, b = x[0::2], x[1::2]
        a32 = a.float().reshape(a.shape[0], -1)
        b32 = b.float().reshape(b.shape[0], -1)
        dot = (a32 * b32).sum(1)
        asq = (a32 * a32).sum(1)
        bsq = (b32 * b32).sum(1)
        shape = (a.shape[0],) + (1,) * (a.dim() - 1)
        one = torch.ones_like(dot)
        acoef = torch.where(asq > 0, one - dot / (2 * asq), one).reshape(
            shape)
        bcoef = torch.where(bsq > 0, one - dot / (2 * bsq), one).reshape(
            shape)
        x = acoef.to(a.dtype) * a + bcoef.to(b.dtype) * b
    return x[0]
