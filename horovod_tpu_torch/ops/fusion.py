"""Tensor fusion: many small tensors reduced as few large collectives.

Counterpart of ``horovod_tpu/ops/fusion.py``.  Tensors are grouped by
dtype, in submission order, into buckets of at most the threshold's
bytes; each bucket is flattened and concatenated, reduced by ONE
collective, and split back into views of the result.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

from horovod_tpu_torch.ops import collectives as C

__all__ = ["DEFAULT_FUSION_THRESHOLD", "fused_allreduce",
           "fusion_threshold_bytes", "make_buckets"]

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024  # bytes


def fusion_threshold_bytes() -> int:
    """Threshold resolution order: the live autotuner's (the tuned value,
    applied each sample window) → ``HOROVOD_FUSION_THRESHOLD`` → 64 MB.
    A captured step buckets with the value read at its capture; the
    eager path reads it on every call."""
    from horovod_tpu_torch import basics

    if basics.is_initialized():
        at = basics._ctx().autotuner
        if at is not None:
            return int(at.fusion_threshold)
    v = os.environ.get("HOROVOD_FUSION_THRESHOLD")
    return int(v) if v else DEFAULT_FUSION_THRESHOLD


def make_buckets(tensors: Sequence[torch.Tensor],
                 threshold: int) -> List[List[int]]:
    """Greedy dtype-grouped bucketing -> lists of tensor indices.  Groups
    come in order of their dtype's first appearance and keep submission
    order; a bucket closes when the next tensor would take it past
    ``threshold`` bytes (a larger tensor gets a bucket of its own)."""
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    buckets: List[List[int]] = []
    for idxs in by_dtype.values():
        cur: List[int] = []
        cur_bytes = 0
        for i in idxs:
            nbytes = tensors[i].numel() * tensors[i].element_size()
            if cur and cur_bytes + nbytes > threshold:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            buckets.append(cur)
    return buckets


def fused_allreduce(tensors: Sequence[torch.Tensor], op: str = C.Average,
                    threshold: Optional[int] = None, *,
                    axis_name=None) -> List[torch.Tensor]:
    """Allreduce every tensor, bucket by bucket: flatten, concatenate,
    one collective, split.  Returns new tensors in the input order.
    ``axis_name``: over the ranks of that axis or tuple of axes
    (``collectives.allreduce``)."""
    if threshold is None:
        threshold = fusion_threshold_bytes()
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idxs in make_buckets(tensors, threshold):
        group = [tensors[i] for i in idxs]
        buf = C.allreduce_(torch.cat([t.reshape(-1) for t in group]), op,
                           axis_name=axis_name)
        pieces = buf.split([t.numel() for t in group])
        for i, t, piece in zip(idxs, group, pieces):
            out[i] = piece.view(t.shape)
    return out
