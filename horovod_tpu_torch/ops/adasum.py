"""Adasum: scale-insensitive gradient reduction over ``torch.distributed``.

Counterpart of ``horovod_tpu/ops/adasum.py``.  The pairwise combination

    a' = (1 - a.b / (2 |a|^2)) * a  +  (1 - a.b / (2 |b|^2)) * b

(zero-norm guards: a zero tensor's coefficient is 1; dot products in
f32) is applied over the recursive exchange of ``_adasum_over_axis``: at
level ``k`` each rank swaps its tensor with the rank ``rank ^ 2^k`` of
its group (``dist.batch_isend_irecv``, both directions posted together,
so no pair waits on the other) and both compute the pair's combination
with the lower rank as ``a``, so after log2(P) levels every rank holds
the same result.  The group's size must be a power of two; at size 1 it
is the identity.  The hierarchical form averages over the local group,
then runs Adasum over the cross group.
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


def _check_size(n: int) -> None:
    if n & (n - 1) != 0:
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


def adasum_allreduce_group(tensors: Sequence[torch.Tensor], *,
                           hierarchical: bool = False
                           ) -> List[torch.Tensor]:
    """Adasum of a group of tensors: the log2(P) exchange rounds are
    shared, each tensor keeps its own coefficients (the JAX
    ``eager_adasum_group``).  ``hierarchical`` (on a homogeneous job, as
    the collectives decide it) first averages over the local group, then
    combines across hosts: the JAX form over ``(cross, local)``."""
    tensors = list(tensors)
    ctx = basics._ctx()
    if not hierarchical:
        return _adasum_over(tensors, list(range(ctx.size)), None)
    _check_size(ctx.cross_size)
    local = []
    for t in tensors:
        t = t.contiguous().clone()
        dist.all_reduce(t, group=ctx.local_group)
        local.append(t.div_(ctx.local_size))
    return _adasum_over(local, list(ctx.cross_ranks), ctx.cross_group)


def adasum_allreduce(tensor: torch.Tensor, *,
                     hierarchical: bool = False) -> torch.Tensor:
    """Adasum of one tensor over the job -> a new tensor, equal on every
    rank (see :func:`adasum_allreduce_group`)."""
    return adasum_allreduce_group([tensor], hierarchical=hierarchical)[0]


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
