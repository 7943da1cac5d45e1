"""Gradient averaging for data-parallel training: ``DistributedOptimizer``.

Counterpart of ``horovod_tpu/optim.py`` (``distributed_gradients``,
``DistributedOptimizer``) in the torch shape of the JAX package's own
PyTorch frontend (``horovod_tpu/torch/__init__.py``): the wrapper is a
subclass of the wrapped optimizer's class, and ``step()`` reduces the
gradients through fused buckets before the update.  There are no hooks:
the reduction runs when ``step()`` is called, after the backward.

Semantics kept from the JAX package:

* ``op`` Average or Sum; ``compression`` casts for the wire only.
* ``backward_passes_per_step = k``: gradients of k backward passes
  accumulate locally (in ``.grad``; ``zero_grad`` keeps them until the
  k-th ``step``), and only every k-th ``step()`` reduces and updates;
  the others change nothing.  ``average_aggregated_gradients`` divides
  the accumulated sum by k before the reduction.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops import fusion as F
from horovod_tpu_torch.ops.compression import Compression

__all__ = ["DistributedOptimizer", "broadcast_optimizer_state",
           "broadcast_parameters", "distributed_gradients",
           "named_parameters"]


def named_parameters(tree: Dict, prefix: str = "") -> List[
        Tuple[str, torch.Tensor]]:
    """``(dotted name, tensor)`` for every tensor of a nested dict, in
    insertion order (``{"layers": {"wq": t}}`` -> ``[("layers.wq", t)]``)."""
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(named_parameters(v, name + "."))
        else:
            out.append((name, v))
    return out


def distributed_gradients(grads: Sequence[torch.Tensor], op: str = C.Average,
                          *, compression=Compression.none, fuse: bool = True,
                          fusion_threshold: Optional[int] = None
                          ) -> List[torch.Tensor]:
    """Allreduce a list of gradients -> new tensors in the same order:
    compressed for the wire, reduced through fused buckets
    (:mod:`~horovod_tpu_torch.ops.fusion`) or one collective each, and
    restored to their dtypes."""
    packed = [compression.compress(g) for g in grads]
    wire = [t for t, _ in packed]
    if fuse:
        reduced = F.fused_allreduce(wire, op, fusion_threshold)
    else:
        reduced = [C.allreduce(t, op) for t in wire]
    return [compression.decompress(r, ctx)
            for r, (_, ctx) in zip(reduced, packed)]


class _DistributedOptimizer(torch.optim.Optimizer):
    """Mixed in ahead of the wrapped optimizer's class (see
    :func:`DistributedOptimizer`)."""

    def __init__(self, inner: torch.optim.Optimizer, op, compression,
                 backward_passes_per_step, average_aggregated_gradients,
                 fuse, fusion_threshold):
        super().__init__(inner.param_groups)  # the wrapped class's init
        self.defaults.update(inner.defaults)
        self._op = op
        self._compression = compression
        self._passes_per_step = backward_passes_per_step
        self._average_aggregated = average_aggregated_gradients
        self._fuse = fuse
        self._fusion_threshold = fusion_threshold
        self._passes = 0

    def synchronize(self) -> None:
        """Reduce every parameter's gradient across the ranks, in place.
        A parameter without a gradient contributes zeros, so every rank
        reduces the same tensors."""
        params = [p for g in self.param_groups for p in g["params"]
                  if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        k = self._passes_per_step
        if k > 1 and self._average_aggregated:
            for g in grads:
                g.mul_(1.0 / k)
        reduced = distributed_gradients(
            grads, self._op, compression=self._compression, fuse=self._fuse,
            fusion_threshold=self._fusion_threshold)
        for g, r in zip(grads, reduced):
            g.copy_(r)

    def step(self, closure=None):
        """Every ``backward_passes_per_step``-th call: reduce, then the
        wrapped optimizer's update.  Other calls return ``None`` and
        change nothing."""
        self._passes += 1
        if self._passes < self._passes_per_step:
            return None
        self._passes = 0
        self.synchronize()
        return super().step(closure)

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Clears the gradients, except between the backward passes of
        one accumulation window, where they must add up."""
        if self._passes == 0:
            super().zero_grad(set_to_none=set_to_none)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None, op: str = C.Average,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         average_aggregated_gradients: bool = True,
                         fuse: bool = True,
                         fusion_threshold: Optional[int] = None):
    """Wrap a freshly built ``torch.optim.Optimizer`` so that ``step()``
    updates from gradients reduced across the ranks.

    Returns an instance of a subclass of the optimizer's own class over
    the same parameter groups (its state is not carried over).
    ``named_parameters`` (pairs ``(name, tensor)``), when given, must name
    exactly the optimizer's parameters, each once.

    Note ``torch.optim.AdamW`` decays by 1e-2 by default, ``optax.adamw``
    by 1e-4: pass ``weight_decay`` explicitly to match the JAX package."""
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if named_parameters is not None:
        pairs = list(named_parameters)
        names = [n for n, _ in pairs]
        if len(set(names)) < len(names):
            raise ValueError("named_parameters has duplicate names")
        ours = {id(p) for g in optimizer.param_groups for p in g["params"]}
        if {id(t) for _, t in pairs} != ours or len(pairs) != len(ours):
            raise ValueError("named_parameters must name exactly the "
                             "optimizer's parameters")
    cls = type(optimizer.__class__.__name__,
               (_DistributedOptimizer, optimizer.__class__), {})
    return cls(optimizer, op, compression, backward_passes_per_step,
               average_aggregated_gradients, fuse, fusion_threshold)


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Overwrite every tensor of ``params`` — a nested dict of tensors,
    or pairs ``(name, tensor)`` — with ``root_rank``'s, in place."""
    items = (named_parameters(params) if isinstance(params, dict)
             else list(params))
    with torch.no_grad():
        for _, t in items:
            C.broadcast_(t, root_rank)


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Load ``root_rank``'s optimizer state (moments, step counts, group
    hyperparameters) into every rank's ``optimizer``.  The state dict
    travels pickled, so a rank without state yet (no step taken) gets
    it all the same."""
    basics.size()
    box = [_to_cpu(optimizer.state_dict())
           if basics.rank() == root_rank else None]
    dist.broadcast_object_list(box, src=root_rank)
    optimizer.load_state_dict(box[0])
