"""The train steps, and ``shard_map`` over the worker mesh.

Counterpart of ``horovod_tpu/spmd.py``: :func:`make_train_step`,
:func:`make_gspmd_train_step`, :func:`shard` / :func:`run` (the port's
``shard_map``) and :func:`init_replicated` / :func:`shard_batch`.

The data-parallel step: every rank
calls ``step`` with its own shard of the batch; the optimizer (a
:func:`~horovod_tpu_torch.optim.DistributedOptimizer`) reduces the
gradients before its update, and the loss is averaged over the ranks.
With ``mesh=`` the step runs under that mesh's binding and ``axis=``
names the axis the loss is averaged over (the model's expert
parallelism trains this way over ``ep``, with
``DistributedOptimizer(axis_name="ep")``).

Where the JAX package compiles forward, backward, gradient allreduce and
update into one program, the port captures them on the card as one CUDA
graph (:class:`TrainStep`): the first calls run the step's eager body
and count as steps (the warm-up, on a side stream, which also creates the
optimizer's state and the collectives' communicators), the next call
captures the body and replays it, and every later call copies its batch
into the graph's static inputs and replays.  As the JAX step retraces
for a new shape, a batch of a shape or dtype not seen yet is captured
at its first call, into the same memory pool.  The optimizer's settings
are baked into the graphs, except a device-tensor ``lr`` (Adam, AdamW
and SGD, see :mod:`horovod_tpu_torch.optim`), which every replay reads:
a change to any other setting of ``param_groups`` drops the graphs and
the call captures anew.  With ``backward_passes_per_step = k > 1``
there are two graphs a shape, as the JAX step's ``lax.cond`` compiles
both branches: an accumulate pass (forward and backward into the
gradients) and a boundary pass (the same, then the reduction, the
update and the gradients zeroed in place).  On the CPU, and for an
optimizer whose reduction cannot be captured (Adasum's point-to-point
rounds, the sparse route's host read of its row count: ``graph_safe``
false), every call runs the eager body; which one runs is decided by
the device and the optimizer's type, never by a caught error.

The GSPMD step (:class:`GSPMDStep`): parameters are DTensors placed by
JAX-style specs over a mesh, and DTensor's sharding propagation inserts
the collectives that XLA's inserts in JAX.  Its forward and backward run
under the mesh's binding and ``implicit_replication`` (a plain tensor
made inside the model, a RoPE table or a mask, counts as replicated;
the backward runs under it too, as its saved plain tensors meet DTensor
gradients).  It is captured as :class:`TrainStep` is: at mesh size 1
DTensor's dispatch is host work only, and the replays carry none.
Every axis of the mesh may be larger than 1: over pp the layer stack is
gathered where the forward unbinds it, over ep the MoE block gathers
the experts.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from horovod_tpu_torch import basics
from horovod_tpu_torch._capture import capture
from horovod_tpu_torch.ops import attention as attn
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops import grouped_matmul as gmm
from horovod_tpu_torch.optim import _set_capturable
from horovod_tpu_torch.parallel import meshes
from horovod_tpu_torch.parallel.sharding import (NamedSharding, P,
                                                 distribute, named_shardings,
                                                 tree_map, tree_map_specs)

__all__ = ["GSPMDStep", "TrainStep", "init_replicated",
           "make_gspmd_train_step", "make_train_step", "run", "shard",
           "shard_batch"]

#: Eager steps before the capture (rounded up to whole accumulation
#: windows).
WARMUP_STEPS = 2

# The launch counters a step can move: K1-K3, and G1 and G2 (the dropless
# MoE dispatch).
_COUNTERS = ((attn, "flash_fwd_launches"), (attn, "flash_bwd_dkdv_launches"),
             (attn, "flash_bwd_dq_launches"), (gmm, "grouped_matmul_launches"),
             (gmm, "grouped_matmul_dw_launches"))


class _Graph:
    """One captured pass, its outputs and the kernel launches it makes a
    replay (the wrappers count at capture, where nothing launches: the
    count is taken back and added each replay)."""

    def __init__(self, graph, out, launches):
        self.graph, self.out, self.launches = graph, out, launches

    def replay(self):
        self.graph.replay()
        for (mod, name), n in zip(_COUNTERS, self.launches):
            setattr(mod, name, getattr(mod, name) + n)
        return self.out


class TrainStep:
    """``step(params, batch)`` -> the loss averaged over the ranks (and
    the rank's ``aux`` with ``has_aux``); see :func:`make_train_step`.

    ``graphed`` says whether calls past the warm-up replay CUDA graphs;
    ``captures`` and ``replays`` count them."""

    def __init__(self, loss_fn, optimizer, has_aux, hierarchical,
                 mesh=None, axis=None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.has_aux = has_aux
        self.hierarchical = hierarchical
        self.mesh = mesh
        self.axis = axis
        self.k = getattr(optimizer, "backward_passes_per_step", 1)
        params = [p for g in optimizer.param_groups for p in g["params"]]
        self.graphed = bool(params and params[0].is_cuda
                            and getattr(optimizer, "graph_safe", True))
        self.calls = 0
        self.captures = 0
        self.replays = 0
        # By the batch's (name, shape, dtype)s: the graphs of that shape
        # and their static inputs.
        self._graphs: Dict[tuple, Dict[str, _Graph]] = {}
        self._static: Dict[tuple, Dict] = {}
        self._pool = None
        self._settings = None
        self._params = None

    # -- the step's bodies ---------------------------------------------------

    def _forward_backward(self, params, batch):
        out = self.loss_fn(params, batch)
        loss, aux = out if self.has_aux else (out, None)
        loss.backward()
        return loss, aux

    def _result(self, loss, aux):
        avg = C.allreduce(loss.detach(), C.Average, axis_name=self.axis)
        if not self.has_aux:
            return avg
        return avg, tree_map(lambda t: t.detach(), aux)

    def _bound(self):
        """The step's mesh bound (``parallel.bind``), if it has one."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return meshes.bind(self.mesh)

    def body(self, params, batch):
        """The eager step: zero the gradients, forward, backward, the
        optimizer's step (parameters updated in place), the loss
        averaged over the ranks (of ``axis``), all under the step's
        mesh."""
        with C._hierarchical(self.hierarchical), self._bound():
            self.optimizer.zero_grad()
            loss, aux = self._forward_backward(params, batch)
            self.optimizer.step()
            return self._result(loss, aux)

    def _captured_body(self, params, batch, boundary: bool):
        """What a graph holds.  k = 1: the eager body, whose gradients the
        capture allocates from the graph's pool (they are None at the
        capture).  k > 1: the backward accumulates into gradients that
        exist; the boundary pass then reduces, updates and zeroes them."""
        if self.k == 1:
            return self.body(params, batch)
        with C._hierarchical(self.hierarchical), self._bound():
            loss, aux = self._forward_backward(params, batch)
            if boundary:
                self.optimizer._update()
                for p in self._grad_params():
                    p.grad.zero_()
            return self._result(loss, aux)

    def _grad_params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]
                if p.requires_grad]

    # -- capture and replay --------------------------------------------------

    def _current_settings(self) -> list:
        """Every group's settings but its parameters and its device-tensor
        ``lr``: what a capture bakes in."""
        return [{k: v for k, v in g.items()
                 if k != "params" and not (k == "lr" and torch.is_tensor(v)
                                           and v.is_cuda)}
                for g in self.optimizer.param_groups]

    def _capture(self, key, params, batch) -> None:
        """The graphs of ``batch``'s shape.  k = 1: gradients None, so
        the capture allocates them.  k > 1: gradients that every graph
        shares, zero at an accumulation window's start."""
        self._static[key] = {k: v.clone() for k, v in batch.items()}
        self._params = params
        if self.k == 1:
            self.optimizer.zero_grad(set_to_none=True)
        else:
            for p in self._grad_params():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                elif self.optimizer._passes == 0:
                    p.grad.zero_()
        kinds = ("step",) if self.k == 1 else ("accumulate", "boundary")
        graphs = {}
        for kind in kinds:
            before = [getattr(mod, n) for mod, n in _COUNTERS]
            graph = torch.cuda.CUDAGraph()
            with capture(graph, self._pool):
                out = self._captured_body(params, self._static[key],
                                          kind != "accumulate")
            launches = [getattr(mod, n) - b
                        for (mod, n), b in zip(_COUNTERS, before)]
            for (mod, n), b in zip(_COUNTERS, before):
                setattr(mod, n, b)
            # Every graph shares one pool and they replay one at a time;
            # each replay's outputs are cloned before the next replay.
            self._pool = graph.pool()
            graphs[kind] = _Graph(graph, out, launches)
            self.captures += 1
        self._graphs[key] = graphs

    def _replay(self, params, batch):
        if self._params is not None and params is not self._params:
            raise ValueError("a captured train step runs on the parameters "
                             "it was captured with")
        bind_lr = getattr(self.optimizer, "bind_lr", None)
        if bind_lr is not None:
            bind_lr()
        settings = self._current_settings()
        if settings != self._settings:
            self._graphs.clear()
            self._static.clear()
            self._pool = None
            self._settings = settings
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        if key not in self._graphs:
            self._capture(key, params, batch)
        for k, v in batch.items():
            self._static[key][k].copy_(v)
        if self.k == 1:
            kind = "step"
        else:
            opt = self.optimizer
            boundary = opt._passes + 1 >= self.k
            kind = "boundary" if boundary else "accumulate"
            opt._passes = 0 if boundary else opt._passes + 1
        out = self._graphs[key][kind].replay()
        self.replays += 1
        return tree_map(lambda t: t.clone(), out)

    def __call__(self, params, batch):
        self.calls += 1
        if not self.graphed:
            return self.body(params, batch)
        warmup = self.k * -(-WARMUP_STEPS // self.k)
        if self.calls <= warmup:
            stream = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                out = self.body(params, batch)
            stream.wait_stream(side)
            return out
        return self._replay(params, batch)


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, *,
                    mesh=None, axis: Optional[str] = None,
                    has_aux: bool = False,
                    hierarchical: Optional[bool] = None) -> TrainStep:
    """``loss_fn(params, batch) -> scalar loss`` (``(loss, aux)`` with
    ``has_aux``) and an optimizer over the tensors of ``params`` ->
    ``step(params, batch) -> loss`` (``(loss, aux)``): zero the
    gradients, forward, backward, the optimizer's step (parameters are
    updated in place), and the loss averaged over the ranks; ``aux`` is
    this rank's.  On CUDA the step is captured as CUDA graphs after its
    warm-up (:class:`TrainStep`).

    ``mesh`` (from ``parallel.make_mesh``) is bound while the step runs,
    as JAX's step runs under ``shard_map`` over it: the model's axes
    (``moe_axis``, the sequence-parallel ``sp``) and an optimizer's
    ``axis_name`` read it.  ``axis`` names the axis the loss is averaged
    over (a mesh axis, or one of ``basics``' flat names); by default the
    whole job.  Each rank passes its own shard of the batch, as without
    them.

    ``hierarchical`` (default: ``HOROVOD_HIERARCHICAL_ALLREDUCE`` or
    ``HOROVOD_HIERARCHICAL_ALLGATHER`` set) makes the step's collectives
    two-level, as the JAX step built over the ``(cross, local)`` mesh.

    On CUDA a new batch shape or dtype captures once more (a short last
    batch, another sequence length), and a change to the optimizer's
    settings other than the device-tensor ``lr`` of Adam, AdamW and SGD
    captures anew: a scheduler that sets, say, a float momentum every
    step captures every step."""
    if hierarchical is None:
        hierarchical = (C._env_flag("HOROVOD_HIERARCHICAL_ALLREDUCE")
                        or C._env_flag("HOROVOD_HIERARCHICAL_ALLGATHER"))
    return TrainStep(loss_fn, optimizer, has_aux, hierarchical, mesh, axis)


# --- shard_map over the worker mesh ------------------------------------------


def shard(fn, *, in_specs, out_specs, mesh=None,
          check_replication: bool = False):
    """The port's ``shard_map``: a callable that binds ``mesh`` (default
    :func:`basics.mesh`; ``parallel.bind``), gives ``fn`` each argument's
    local shard under its in-spec (a DTensor redistributed first if
    need be; a plain tensor is the same global value on every rank, and
    is split by its spec), and wraps each output of ``fn`` as a DTensor
    of its out-spec (``P()``: replicated).  Specs are trees of
    :class:`~horovod_tpu_torch.parallel.sharding.PartitionSpec` matching
    the arguments (or a prefix of them).  ``check_replication`` is
    accepted and ignored, as JAX's ``check_vma=False``."""
    mesh = mesh if mesh is not None else basics.mesh()
    ins = named_shardings(mesh, in_specs)
    outs = named_shardings(mesh, out_specs)

    def local(t, sharding):
        return sharding.place(t).to_local()

    def wrap(t, sharding):
        return DTensor.from_local(t, sharding.device_mesh,
                                  sharding.placements, run_check=False)

    def sharded(*args):
        with meshes.bind(mesh):
            out = fn(*tree_map_specs(local, tuple(args), ins))
        return tree_map_specs(wrap, out, outs)

    return sharded


def run(fn, *args, in_specs, out_specs, mesh=None):
    """Call :func:`shard` once."""
    return shard(fn, in_specs=in_specs, out_specs=out_specs,
                 mesh=mesh)(*args)


def init_replicated(params, mesh=None):
    """A tree of full tensors (the same on every rank) as DTensors
    replicated over ``mesh`` (default :func:`basics.mesh`)."""
    mesh = mesh if mesh is not None else basics.mesh()
    return distribute(params, NamedSharding(mesh, P()))


def shard_batch(batch, mesh=None, axis: Optional[str] = None):
    """A tree of global batch tensors (the same on every rank) as DTensors
    sharded on dimension 0 over ``axis`` (default the flat mesh's)."""
    mesh = mesh if mesh is not None else basics.mesh()
    return distribute(batch, NamedSharding(mesh,
                                           P(axis or basics.axis_name())))


# --- the GSPMD step ----------------------------------------------------------


class GSPMDStep(TrainStep):
    """``step(params, batch)`` -> the loss, a plain tensor equal on every
    rank; see :func:`make_gspmd_train_step`.  The capture and replay are
    :class:`TrainStep`'s."""

    def __init__(self, loss_fn, optimizer, mesh, param_spec, batch_spec):
        _set_capturable(optimizer)
        super().__init__(loss_fn, optimizer, False, False, mesh)
        self.param_shardings = named_shardings(mesh, param_spec)
        self.batch_shardings = named_shardings(mesh, batch_spec)

    def _check_params(self, params) -> None:
        def check(t, sharding):
            if not (isinstance(t, DTensor)
                    and t.device_mesh == sharding.device_mesh
                    and tuple(t.placements) == sharding.placements):
                raise ValueError(
                    "make_gspmd_train_step: every parameter must be a "
                    f"DTensor placed by its spec ({sharding}); got "
                    f"{getattr(t, 'placements', type(t).__name__)}")

        tree_map_specs(check, params, self.param_shardings)

    def body(self, params, batch):
        """Place the batch by its specs, zero the gradients, forward and
        backward under the mesh's binding (plain tensors made inside the
        model count as replicated), the optimizer's step."""
        batch = distribute(batch, self.batch_shardings)
        with meshes.bind(self.mesh), implicit_replication():
            self.optimizer.zero_grad()
            loss = self.loss_fn(params, batch)
            loss.backward()
            self.optimizer.step()
        loss = loss.detach()
        return loss.full_tensor() if isinstance(loss, DTensor) else loss

    def __call__(self, params, batch):
        if self.calls == 0:
            self._check_params(params)
        return super().__call__(params, batch)


def make_gspmd_train_step(loss_fn: Callable,
                          optimizer: torch.optim.Optimizer, *, mesh,
                          param_spec, batch_spec,
                          donate: bool = True) -> GSPMDStep:
    """The train step in GSPMD style (JAX's ``make_gspmd_train_step``):
    the parameters are DTensors placed by ``param_spec`` over ``mesh``
    (from ``parallel.make_mesh``; placed by :func:`init_replicated`,
    ``parallel.sharding.distribute`` or a pod checkpoint's restore), a
    plain batch is placed by ``batch_spec``, and DTensor's sharding
    propagation inserts every collective: gradient reductions over dp
    and fsdp, tp's gathers and reductions, sp's gathers, pp's and ep's
    gathers of the layer stack and the experts on use.  The same plain
    ``loss_fn(params, batch)`` serves :func:`make_train_step`.

    Over pp the layer stack is sharded and gathered where the forward
    reads it (JAX's layer-stack sharding, no pipeline: that is
    ``models.transformer.pipelined_value_and_grad``); over ep the
    expert stacks are sharded and the MoE block gathers them, dispatching
    every token on every rank as the GSPMD MoE block does.

    ``optimizer`` is a plain ``torch.optim`` optimizer over the DTensor
    parameters, so its state is sharded as they are (ZeRO-3 over fsdp);
    the update is in place (``donate`` is accepted).  On CUDA the step is
    captured as a CUDA graph after its warm-up, as :class:`TrainStep`
    (``capturable`` is set on the optimizer).
    ``step(params, batch) -> loss``."""
    return GSPMDStep(loss_fn, optimizer, mesh, param_spec, batch_spec)
