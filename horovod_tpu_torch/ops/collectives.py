"""Collectives over ``torch.distributed``: the subset the data-parallel
step needs.

Counterpart of ``horovod_tpu/ops/collectives.py`` (``allreduce``,
``allgather``, ``broadcast``, ``barrier``), with its op names.  Every
call is collective: each rank of the job (:mod:`horovod_tpu_torch.
basics`) makes it, in the same order.  The trailing-underscore forms
work in place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics

__all__ = ["Average", "Sum", "allgather", "allreduce", "allreduce_",
           "barrier", "broadcast", "broadcast_"]

Average = "Average"
Sum = "Sum"


def allreduce_(tensor: torch.Tensor, op: str = Average) -> torch.Tensor:
    """Sum ``tensor`` over the ranks in place (``Average`` then divides
    by the job's size) and return it."""
    n = basics.size()
    if op not in (Average, Sum):
        raise ValueError(f"allreduce op {op!r} is not ported; expected "
                         f"{Average!r} or {Sum!r}")
    if op == Average and not tensor.is_floating_point():
        raise TypeError(f"Average needs a floating tensor, got {tensor.dtype}")
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    if op == Average:
        tensor.div_(n)
    return tensor


def allreduce(tensor: torch.Tensor, op: str = Average) -> torch.Tensor:
    """:func:`allreduce_` into a new tensor."""
    return allreduce_(tensor.clone(), op)


def allgather(tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along dim 0, in rank order;
    the first dimension may differ between ranks."""
    n = basics.size()
    rows = torch.tensor([tensor.shape[0]], device=tensor.device)
    all_rows = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(all_rows, rows)
    counts = [int(r) for r in all_rows]
    padded = tensor.new_zeros((max(counts),) + tuple(tensor.shape[1:]))
    padded[:tensor.shape[0]] = tensor
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


def broadcast_(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """Overwrite ``tensor`` with ``root_rank``'s, in place."""
    basics.size()  # raises before init
    dist.broadcast(tensor, src=root_rank)
    return tensor


def broadcast(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """:func:`broadcast_` into a new tensor."""
    return broadcast_(tensor.clone(), root_rank)


def barrier() -> None:
    """Return once every rank has called it."""
    basics.size()
    dist.barrier()
