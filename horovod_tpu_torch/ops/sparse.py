"""Sparse (row-indexed) gradient reduction for embedding-shaped gradients.

Counterpart of ``horovod_tpu/ops/sparse.py``: a dense gradient that is
zero outside the rows a step touched reduces by allgathering the touched
rows' indices and values and scatter-adding them, so the wire carries
the touched rows instead of the table.  The result equals the dense
allreduce's (up to f32 summation order).

A rank is one process driving one device, so the JAX eager path's chip
weighting (each process's rows times its ``local_size()`` chips) is 1
here: every rank's rows count once.  Finding the touched rows reads
their count back to the host, so the sparse route is eager only (a
captured train step reduces densely or not at all; see
:mod:`horovod_tpu_torch.spmd`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collectives as C

__all__ = ["merge_sparse_leaves", "sparse_allreduce", "split_sparse_leaves"]


def sparse_allreduce(grad: torch.Tensor, op: str = C.Average, *,
                     return_stats: bool = False):
    """Reduce a row-sparse dense gradient by allgathering touched rows.

    ``grad`` ``(V, ...)`` is zero except in the rows a step touched.  A
    rank that touched no row still joins both allgathers (with zero
    rows), so no rank skips a collective its peers make.  Returns the
    reduced gradient, or ``(grad, stats)`` with ``return_stats``:
    ``{"rows", "total_rows", "sparse_bytes", "dense_bytes"}`` (int32
    row indices, as the JAX package sends)."""
    if op not in (C.Sum, C.Average):
        raise ValueError(f"sparse_allreduce supports Sum/Average, got {op!r}")
    if grad.dim() < 1:
        raise ValueError("sparse_allreduce needs a row dimension")
    flat = grad.reshape(grad.shape[0], -1)
    rows = torch.nonzero((flat != 0).any(dim=1)).flatten().to(torch.int32)
    vals = flat[rows.long()].contiguous()
    all_rows = C.allgather(rows)
    all_vals = C.allgather(vals)
    out = torch.zeros_like(flat)
    out.index_add_(0, all_rows, all_vals)
    if op == C.Average:
        out /= basics.size()
    out = out.reshape(grad.shape)
    if not return_stats:
        return out
    stats = {"rows": int(rows.numel()), "total_rows": int(grad.shape[0]),
             "sparse_bytes": int(rows.numel() * rows.element_size()
                                 + vals.numel() * vals.element_size()),
             "dense_bytes": int(grad.numel() * grad.element_size())}
    return out, stats


def split_sparse_leaves(named: Sequence[Tuple[str, torch.Tensor]],
                        sparse_keys: Tuple[str, ...]):
    """``[(name, gradient)]`` (the port's ``named_parameters`` names) ->
    ``(dense, sparse)``: ``dense`` the gradients in order with None where
    a gradient routes sparse, ``sparse`` ``[(index, name, gradient)]`` of
    those whose name contains a key of ``sparse_keys`` (and that have a
    row dimension)."""
    dense: List[Optional[torch.Tensor]] = []
    sparse = []
    for i, (name, g) in enumerate(named):
        if any(k in name for k in sparse_keys) and g.dim() >= 1:
            sparse.append((i, name, g))
            dense.append(None)
        else:
            dense.append(g)
    return dense, sparse


def merge_sparse_leaves(dense: Sequence[Optional[torch.Tensor]],
                        reduced_sparse) -> List[torch.Tensor]:
    """Put ``[(index, gradient)]`` back into ``dense``'s None slots."""
    out = list(dense)
    for i, g in reduced_sparse:
        out[i] = g
    return out
