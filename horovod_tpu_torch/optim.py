"""Gradient reduction for data-parallel training: ``DistributedOptimizer``,
``DistributedAdasumOptimizer`` and ``DistributedGradientTape``.

Counterpart of ``horovod_tpu/optim.py`` in the torch shape of the JAX
package's own PyTorch frontend (``horovod_tpu/torch/__init__.py``): a
wrapper is a subclass of the wrapped optimizer's class, and ``step()``
reduces before (or, for Adasum's delta model, after) the update.  There
are no hooks: the reduction runs when ``step()`` is called, after the
backward.

Semantics kept from the JAX package:

* ``op`` Average, Sum (fused buckets) or any other reduce op (one
  collective a tensor, Adasum included); ``compression`` casts for the
  wire only; ``sparse_keys`` routes the gradients whose names contain a
  key through :func:`~horovod_tpu_torch.ops.sparse.sparse_allreduce`,
  uncompressed (Average and Sum only); with an ``axis_name`` they
  reduce densely over the axis, as JAX's traced leaves do.
* ``backward_passes_per_step = k``: gradients of k backward passes
  accumulate locally (in ``.grad``; ``zero_grad`` keeps them until the
  k-th ``step``), and only every k-th ``step()`` reduces and updates;
  the others change nothing.  ``average_aggregated_gradients`` divides
  the accumulated sum by k before the reduction.
* On CUDA the wrapper sets ``capturable=True`` on the wrapped optimizer
  (its step counts live on the device), so that
  :func:`~horovod_tpu_torch.spmd.make_train_step` can capture the
  update in its CUDA graph.  For Adam, AdamW and SGD it also holds each
  group's ``lr`` as a 0-dim tensor on the device, which a captured
  update reads at every replay: a scheduler's ``fill_`` (the LR
  callbacks' write, :mod:`horovod_tpu_torch.callbacks`) reaches it, and
  a float set by hand or by ``load_state_dict`` is copied into it
  (:meth:`_DistributedOptimizer.bind_lr`).  SGD then runs fused
  (``torch._fused_sgd_`` takes the tensor ``lr`` on the device; the
  foreach SGD reads it on the host, which a capture forbids).

``broadcast_parameters`` and ``broadcast_optimizer_state`` live in
:mod:`horovod_tpu_torch.state` and are re-exported here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops import fusion as F
from horovod_tpu_torch.ops import sparse as SP
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.state import (broadcast_optimizer_state,  # noqa: F401
                                     broadcast_parameters, named_parameters)

__all__ = ["DistributedAdasumOptimizer", "DistributedGradientTape",
           "DistributedOptimizer", "broadcast_optimizer_state",
           "broadcast_parameters", "distributed_gradients",
           "named_parameters"]


def distributed_gradients(grads: Sequence[torch.Tensor], op: str = C.Average,
                          *, axis_name=None, compression=Compression.none,
                          fuse: bool = True,
                          fusion_threshold: Optional[int] = None,
                          sparse_keys=(), names: Sequence[str] = None
                          ) -> List[torch.Tensor]:
    """Allreduce a list of gradients -> new tensors in the same order:
    compressed for the wire, reduced through fused buckets
    (:mod:`~horovod_tpu_torch.ops.fusion`, Average and Sum) or one
    collective each, and restored to their dtypes.  ``axis_name``: over
    the ranks of that axis or tuple of axes only
    (``collectives.allreduce``).  With ``sparse_keys`` (Average and
    Sum), the gradients whose name in ``names`` contains a key reduce by
    :func:`~horovod_tpu_torch.ops.sparse.sparse_allreduce`, uncompressed,
    over the whole job; with ``axis_name`` too they reduce densely over
    the axis with the others, as JAX's traced leaves do in-graph."""
    C._check_op(op)
    grads = list(grads)
    if sparse_keys and op in (C.Average, C.Sum) and axis_name is None:
        if names is None or len(names) != len(grads):
            raise ValueError("sparse_keys needs one name a gradient")
        dense, sparse = SP.split_sparse_leaves(list(zip(names, grads)),
                                               tuple(sparse_keys))
        if sparse:
            idx = [i for i, g in enumerate(dense) if g is not None]
            reduced = distributed_gradients(
                [dense[i] for i in idx], op, compression=compression,
                fuse=fuse, fusion_threshold=fusion_threshold)
            for i, r in zip(idx, reduced):
                dense[i] = r
            return SP.merge_sparse_leaves(
                dense, [(i, SP.sparse_allreduce(g, op))
                        for i, _, g in sparse])
    packed = [compression.compress(g) for g in grads]
    wire = [t for t, _ in packed]
    if fuse and op in (C.Average, C.Sum):
        reduced = F.fused_allreduce(wire, op, fusion_threshold,
                                    axis_name=axis_name)
    else:
        reduced = [C.allreduce(t, op, axis_name=axis_name) for t in wire]
    return [compression.decompress(r, ctx)
            for r, (_, ctx) in zip(reduced, packed)]


def _check_names(optimizer, named_parameters) -> Optional[List[str]]:
    """The names of ``named_parameters`` in the optimizer's parameter
    order (None without them); they must name exactly its parameters."""
    if named_parameters is None:
        return None
    pairs = list(named_parameters)
    names = [n for n, _ in pairs]
    if len(set(names)) < len(names):
        raise ValueError("named_parameters has duplicate names")
    ours = [p for g in optimizer.param_groups for p in g["params"]]
    by_id = {id(t): n for n, t in pairs}
    if set(by_id) != {id(p) for p in ours} or len(pairs) != len(ours):
        raise ValueError("named_parameters must name exactly the "
                         "optimizer's parameters")
    return [by_id[id(p)] for p in ours]


def _set_capturable(optimizer) -> None:
    """Step counts on the device for an optimizer over CUDA parameters,
    where its class has the option."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if params and params[0].is_cuda and "capturable" in optimizer.defaults:
        optimizer.defaults["capturable"] = True
        for g in optimizer.param_groups:
            g["capturable"] = True


def _device_lr(optimizer) -> List[Optional[torch.Tensor]]:
    """Per group, the 0-dim device tensor its ``lr`` lives in: for Adam
    and AdamW over CUDA parameters (whose capturable update reads a
    tensor ``lr`` on the device) and for SGD over CUDA parameters, whose
    group then runs fused (the fused update reads the tensor ``lr`` on
    the device); else None."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW,
                                  torch.optim.SGD)):
        return [None] * len(optimizer.param_groups)
    out = []
    for g in optimizer.param_groups:
        p = g["params"][0] if g["params"] else None
        if p is None or not p.is_cuda:
            out.append(None)
            continue
        if isinstance(optimizer, torch.optim.SGD):
            g["fused"], g["foreach"] = True, False
        out.append(torch.tensor(float(g["lr"]), dtype=torch.float32,
                                device=p.device))
    return out


def _wrap(mixin, optimizer, *args):
    cls = type(optimizer.__class__.__name__, (mixin, optimizer.__class__), {})
    return cls(optimizer, *args)


class _DistributedOptimizer(torch.optim.Optimizer):
    """Mixed in ahead of the wrapped optimizer's class (see
    :func:`DistributedOptimizer`)."""

    def __init__(self, inner: torch.optim.Optimizer, op, compression,
                 backward_passes_per_step, average_aggregated_gradients,
                 axis_name, fuse, fusion_threshold, sparse_keys, names):
        super().__init__(inner.param_groups)  # the wrapped class's init
        self.defaults.update(inner.defaults)
        self._op = op
        self._axis_name = axis_name
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._average_aggregated = average_aggregated_gradients
        self._fuse = fuse
        self._fusion_threshold = fusion_threshold
        self._sparse_keys = tuple(sparse_keys)
        self._names = names
        self._passes = 0
        self._lr = _device_lr(self)
        self.bind_lr()

    def bind_lr(self) -> None:
        """Each group's current ``lr`` into its device tensor, and the
        tensor back into the group (after a float set by hand or a
        loaded state dict): the captured update reads ``lr`` there."""
        for g, lr in zip(self.param_groups, self._lr):
            if lr is not None and g["lr"] is not lr:
                lr.fill_(float(g["lr"]))
                g["lr"] = lr

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        self.bind_lr()

    @property
    def graph_safe(self) -> bool:
        """Whether the reduction can be captured in a CUDA graph: not with
        Adasum (its exchange rounds are point-to-point, eager) nor with
        sparse keys (the touched rows' count is read on the host)."""
        return self._op != C.Adasum and not self._sparse_keys

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
        k = self.backward_passes_per_step
        if k > 1 and self._average_aggregated:
            for g in grads:
                g.mul_(1.0 / k)
        names = None
        if self._names is not None:
            names = [n for n, p in zip(
                self._names, (p for g in self.param_groups
                              for p in g["params"])) if p.requires_grad]
        # Direct, never through the eager runtime: the JAX optimizer's
        # reduction is in-graph (and a captured step cannot wait on a
        # background thread).
        with C._direct_path():
            reduced = distributed_gradients(
                grads, self._op, axis_name=self._axis_name,
                compression=self._compression, fuse=self._fuse,
                fusion_threshold=self._fusion_threshold,
                sparse_keys=self._sparse_keys, names=names)
        for g, r in zip(grads, reduced):
            g.copy_(r)

    def _update(self, closure=None):
        """The reduction, then the wrapped optimizer's update."""
        self.bind_lr()
        self.synchronize()
        return super().step(closure)

    def step(self, closure=None):
        """Every ``backward_passes_per_step``-th call: reduce, then the
        wrapped optimizer's update.  Other calls return ``None`` and
        change nothing."""
        self._passes += 1
        if self._passes < self.backward_passes_per_step:
            return None
        self._passes = 0
        return self._update(closure)

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
                         axis_name=None, fuse: bool = True,
                         fusion_threshold: Optional[int] = None,
                         sparse_keys=()):
    """Wrap a freshly built ``torch.optim.Optimizer`` so that ``step()``
    updates from gradients reduced across the ranks.

    Returns an instance of a subclass of the optimizer's own class over
    the same parameter groups (its state is not carried over).
    ``named_parameters`` (pairs ``(name, tensor)``), when given, must name
    exactly the optimizer's parameters, each once; ``sparse_keys`` needs
    them.  ``op=Adasum`` reduces each gradient by Adasum, unfused.
    ``axis_name`` reduces over one axis's ranks only: a mesh axis or a
    tuple of axes of the mesh bound when ``step()`` runs
    (``parallel.bind``, or ``spmd.make_train_step(mesh=)``), or one of
    ``basics``' flat names; ``NameError`` when the axis is not bound.
    Model-level expert parallelism averages over its ``ep`` axis this
    way (:mod:`~horovod_tpu_torch.models.transformer`).

    Note ``torch.optim.AdamW`` decays by 1e-2 by default, ``optax.adamw``
    by 1e-4: pass ``weight_decay`` explicitly to match the JAX package."""
    C._check_op(op)
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    names = _check_names(optimizer, named_parameters)
    if sparse_keys and names is None:
        raise ValueError("sparse_keys needs named_parameters")
    _set_capturable(optimizer)
    return _wrap(_DistributedOptimizer, optimizer, op, compression,
                 backward_passes_per_step, average_aggregated_gradients,
                 axis_name, fuse, fusion_threshold, sparse_keys, names)


class _DistributedAdasumOptimizer(torch.optim.Optimizer):
    """Mixed in ahead of the wrapped optimizer's class (see
    :func:`DistributedAdasumOptimizer`)."""

    graph_safe = False  # point-to-point exchange rounds: the step is eager

    def __init__(self, inner: torch.optim.Optimizer, compression,
                 backward_passes_per_step, axis_name):
        super().__init__(inner.param_groups)
        self.defaults.update(inner.defaults)
        self._compression = compression
        self._axis_name = axis_name
        self.backward_passes_per_step = backward_passes_per_step
        self._passes = 0
        self._start: Optional[List[torch.Tensor]] = None

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]
                if p.requires_grad]

    def _adasum(self, deltas: List[torch.Tensor]) -> List[torch.Tensor]:
        with C._direct_path():  # the step's reduction, as synchronize's
            return [self._compression.decompress(
                C.allreduce(t, C.Adasum, axis_name=self._axis_name), ctx)
                for t, ctx in (self._compression.compress(d)
                               for d in deltas)]

    @torch.no_grad()
    def step(self, closure=None):
        """The wrapped optimizer's local update; on every
        ``backward_passes_per_step``-th call the drift since the last
        sync is Adasum-reduced and the parameters set to ``start +``
        that.  Over a group of one rank the Adasum of the drift is the
        drift, so the step is the wrapped optimizer's own, bit for bit
        (the reference's factory takes the plain optimizer at size 1):
        nothing is snapshotted, reduced or compressed."""
        if C._axis_group(self._axis_name).size == 1:
            with torch.enable_grad():
                return super().step(closure)
        params = self._params()
        if self._start is None or self.backward_passes_per_step == 1:
            self._start = [p.detach().clone() for p in params]
        with torch.enable_grad():
            loss = super().step(closure)
        self._passes += 1
        if self._passes < self.backward_passes_per_step:
            return loss
        self._passes = 0
        deltas = [p - s for p, s in zip(params, self._start)]
        for p, s, g in zip(params, self._start, self._adasum(deltas)):
            s.add_(g)
            p.copy_(s)
        return loss


def DistributedAdasumOptimizer(optimizer: torch.optim.Optimizer, *,
                               axis_name=None,
                               compression=Compression.none,
                               backward_passes_per_step: int = 1):
    """Delta-model Adasum: combine local optimizer updates, not gradients.

    Each rank runs the wrapped optimizer's own step; the resulting
    parameter delta, which already carries the optimizer's adaptive
    scaling, is Adasum-allreduced:

        start  = params at the last sync
        local  = params after the wrapped step
        params = start + adasum(local - start)

    With ``backward_passes_per_step = k > 1`` the local updates apply for
    k - 1 steps (the ranks drift apart) and the k-th step reduces the
    cumulative drift from ``start`` (the parameters at the first step, then at
    each sync).  ``axis_name``: the delta is Adasum-reduced over that
    axis, or a pair ``(A, B)`` (the mean over ``B``, then Adasum over
    ``A``), as ``adasum.adasum_allreduce``'s; None, over the job.
    Returns an instance of a subclass of the optimizer's class; its step
    runs eagerly, never inside a CUDA graph."""
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    return _wrap(_DistributedAdasumOptimizer, optimizer, compression,
                 backward_passes_per_step, axis_name)


def _unflatten(tree, values, it=None):
    """``values`` in :func:`named_parameters` order, in ``tree``'s nested
    dict shape."""
    it = iter(values) if it is None else it
    return {k: _unflatten(v, None, it) if isinstance(v, dict) else next(it)
            for k, v in tree.items()}


def DistributedGradientTape(fn, *, op: str = C.Average,
                            compression=Compression.none, axis_name=None,
                            has_aux: bool = False, fuse: bool = True,
                            sparse_keys=()):
    """``fn(params, *args) -> loss`` (``(loss, aux)`` with ``has_aux``) ->
    ``wrapped(params, *args) -> (value, grads)``, the JAX package's
    ``value_and_grad`` with reduced gradients: ``value`` as ``fn``
    returned it, ``grads`` the reduced gradients of the loss with respect
    to ``params`` (a nested dict of tensors that require grad, or a list
    of them), in its shape, through ``torch.autograd.grad``.
    ``axis_name`` as :func:`DistributedOptimizer`'s."""
    C._check_op(op)

    def wrapped(params, *args, **kwargs):
        named = (named_parameters(params) if isinstance(params, dict)
                 else [(str(i), t) for i, t in enumerate(params)])
        tensors = [t for _, t in named]
        value = fn(params, *args, **kwargs)
        loss = value[0] if has_aux else value
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, tensors)]
        with C._direct_path():  # JAX's value_and_grad reduces in-graph
            reduced = distributed_gradients(
                grads, op, axis_name=axis_name, compression=compression,
                fuse=fuse, sparse_keys=sparse_keys,
                names=[n for n, _ in named])
        if isinstance(params, dict):
            return value, _unflatten(params, reduced)
        return value, reduced

    return wrapped

