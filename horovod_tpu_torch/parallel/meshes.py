"""Multi-axis mesh construction for dp/fsdp/tp/pp/sp/ep parallelism, and
the binding of its axes to the code that runs on them.

Counterpart of ``horovod_tpu/parallel/meshes.py``.  The mesh is a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
over the job's world (one rank a device), with the JAX package's axis
names and order: axes that carry the heaviest traffic (tp, sp) go
innermost, so that their ranks are neighbours; dp and pp outermost.

Where JAX binds a mesh's axis names with ``shard_map`` and reads them
with ``lax.axis_index`` / ``lax.axis_size``, the port binds a mesh with
:func:`bind` (a context manager on a ``contextvars`` variable) and reads
an axis with :func:`axis_group` (its process group), :func:`axis_index`
(this rank's place on it) and :func:`axis_size`; :func:`axes_group`
resolves a tuple of axes to :class:`Axes`, the group over their
product with its ranks in JAX's order for the tuple.  Outside a
binding they raise ``NameError`` naming the axis, as JAX's unbound-axis
error does.  The binding is read on the host: an axis index is a Python int,
so a CUDA graph captured under it bakes in the right value.  Code that
runs in the autograd engine's threads (a rematerialised layer's
recompute) does not see the caller's binding: read the axis before,
and pass it down.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.basics import resolve_device

__all__ = ["AXIS_ORDER", "Axes", "MeshSpec", "axes_group", "axis_group",
           "axis_index", "axis_name_of", "axis_size", "bind", "infer_spec",
           "make_mesh"]

# Canonical axis order, outermost -> innermost.
AXIS_ORDER = ("dp", "pp", "ep", "fsdp", "sp", "tp")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; unspecified axes default to 1."""

    dp: int = 1
    pp: int = 1
    ep: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def make_mesh(spec: MeshSpec, device=None):
    """A ``DeviceMesh`` with axes (dp, pp, ep, fsdp, sp, tp) over the
    process group's world, rank ``r`` at the place of ``r`` in the
    row-major order of ``spec.shape`` (the innermost axis holds
    consecutive ranks).  ``device``: the device rule of the package,
    CUDA unless the caller passes ``"cpu"``.  Call
    :func:`horovod_tpu_torch.basics.init` first."""
    device_type = resolve_device(device).type
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the job's process group: call "
                           "horovod_tpu_torch.basics.init() first")
    n = dist.get_world_size()
    if spec.size != n:
        raise ValueError(f"MeshSpec size {spec.size} != device count {n}")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(n).reshape(spec.shape),
                      mesh_dim_names=AXIS_ORDER)


def infer_spec(
    n_devices: int,
    *,
    tp: Optional[int] = None,
    sp: Optional[int] = None,
    pp: int = 1,
    ep: int = 1,
    fsdp: int = 1,
) -> MeshSpec:
    """Fill dp with whatever remains after the model axes are chosen."""
    tp = tp or 1
    sp = sp or 1
    model = tp * sp * pp * ep * fsdp
    if n_devices % model != 0:
        raise ValueError(f"{n_devices} devices not divisible by model axes {model}")
    return MeshSpec(dp=n_devices // model, pp=pp, ep=ep, fsdp=fsdp, sp=sp, tp=tp)


# --- the binding ---------------------------------------------------------------

_bound: contextvars.ContextVar = contextvars.ContextVar(
    "horovod_tpu_torch_mesh", default=None)


@contextlib.contextmanager
def bind(mesh):
    """Bind ``mesh``'s axis names for the code in the block (the port's
    counterpart of running under ``shard_map`` over ``mesh``).  Blocks
    nest; the innermost binding wins."""
    token = _bound.set(mesh)
    try:
        yield mesh
    finally:
        _bound.reset(token)


def _dim(name: str):
    mesh = _bound.get()
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        raise NameError(
            f"Found an unbound axis name: {name}. To fix this, run under "
            "horovod_tpu_torch.parallel.bind(make_mesh(...)).")
    return mesh, mesh.mesh_dim_names.index(name)


def axis_group(name: str):
    """The process group of the bound mesh's axis ``name`` that holds
    this rank."""
    mesh, _ = _dim(name)
    return mesh.get_group(name)


def axis_index(name: str) -> int:
    """This rank's index along the bound mesh's axis ``name``."""
    mesh, d = _dim(name)
    return int(mesh.get_coordinate()[d])


def axis_size(name: str) -> int:
    """The size of the bound mesh's axis ``name``."""
    mesh, d = _dim(name)
    return int(mesh.mesh.shape[d])


def axis_name_of(group) -> Optional[str]:
    """The name of the bound mesh's axis whose process group (on this
    rank) is ``group``, or None."""
    mesh = _bound.get()
    if mesh is None:
        return None
    for name in mesh.mesh_dim_names or ():
        if mesh.get_group(name) is group:
            return name
    return None


# --- a tuple of axes ---------------------------------------------------------


@dataclass(frozen=True)
class Axes:
    """A tuple of axes resolved on this rank: ``group``, the process group
    over their product that holds this rank (None: the default group,
    the world); ``ranks``, its global ranks in JAX's order for the tuple
    (the first axis outermost: a rank's index is ``idx * size(a) +
    index(a)`` over the axes in the order they are named); ``index``,
    this rank's place in ``ranks``.  ``world``: the job's own axis (the
    flat name, or the pair ``(cross, local)``), the one the hierarchical
    switches may run two-level."""

    group: object
    ranks: Tuple[int, ...]
    index: int
    world: bool = False

    @property
    def size(self) -> int:
        return len(self.ranks)

    @functools.cached_property
    def perm(self) -> Optional[Tuple[int, ...]]:
        """The JAX index of each rank of ``group`` in the group's own
        order, ascending global ranks (``dist.new_group`` sorts them);
        None where the two orders agree."""
        if list(self.ranks) == sorted(self.ranks):
            return None
        where = {r: j for j, r in enumerate(self.ranks)}
        return tuple(where[r] for r in sorted(self.ranks))

    def to_group_order(self, parts: list) -> list:
        """``parts`` in JAX's order -> in the group's."""
        return parts if self.perm is None else [parts[j] for j in self.perm]

    def to_jax_order(self, parts: list) -> list:
        """``parts`` in the group's order -> in JAX's."""
        if self.perm is None:
            return parts
        out = [None] * len(parts)
        for q, j in enumerate(self.perm):
            out[j] = parts[q]
        return out


# (mesh, tuple) -> this rank's Axes (a DeviceMesh hashes and compares by
# its ranks, names and device type).  Every rank makes every group of a
# tuple's partition, in one order, the first time any collective names
# the tuple; basics.shutdown forgets them with the process group.
_axes_cache: dict = {}


def axes_group(names) -> Axes:
    """The bound mesh's axes ``names`` (a tuple, first axis outermost)
    resolved on this rank (:class:`Axes`).  One axis is the mesh's own
    group; a tuple over the whole world is the default group; any other
    tuple makes one ``dist.new_group`` per group of the partition (every
    rank makes each of them, once a mesh, so every rank must name the
    tuple at the same point, and not first inside a CUDA-graph capture:
    an eager call, such as a captured step's warm-up, makes them).
    ``NameError`` for an unbound axis."""
    names = tuple(names)
    dims = [_dim(n)[1] for n in names]
    if len(set(names)) != len(names):
        raise ValueError(f"axis_name {names!r} names an axis twice")
    mesh = _bound.get()
    hit = _axes_cache.get((mesh, names))
    if hit is not None:
        return hit
    ranks = mesh.mesh
    rest = [d for d in range(ranks.dim()) if d not in dims]
    rows = [tuple(row) for row in ranks.permute(*rest, *dims).reshape(
        -1, int(np.prod([ranks.shape[d] for d in dims]))).tolist()]
    me = dist.get_rank()
    ours = next(row for row in rows if me in row)
    if len(names) == 1:
        group = mesh.get_group(names[0])
    elif len(ours) == dist.get_world_size():
        group = None
    else:
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the process groups of the axes {names!r} are made on "
                "first use, which a CUDA-graph capture cannot hold: call "
                "a collective over them eagerly first")
        group = None
        for row in rows:
            g = dist.new_group(sorted(row))
            if row == ours:
                group = g
    out = Axes(group, ours, ours.index(me))
    _axes_cache[(mesh, names)] = out
    return out


def forget_axes_groups() -> None:
    """Drop the cached tuples' groups (the process group is going)."""
    _axes_cache.clear()
