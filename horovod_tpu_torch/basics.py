"""Process topology over ``torch.distributed``: init, rank and size.

Counterpart of ``horovod_tpu/basics.py``.  A worker is one process
driving one device (the JAX package drives every local chip from one
process; PyTorch's idiom is a process per GPU).

* Rank and size come from the launcher's environment, as in the JAX
  package's ``_bootstrap_distributed``: ``HOROVOD_RANK``,
  ``HOROVOD_SIZE`` (or ``HOROVOD_NUM_PROC``), ``HOROVOD_LOCAL_RANK`` /
  ``HOROVOD_LOCAL_SIZE`` (default: one host) and
  ``HOROVOD_COORDINATOR_ADDR`` (``host`` or ``host:port``; without a
  port, ``HOROVOD_STORE_PORT``, which the launcher's ``run(fn)`` and the
  elastic driver set afresh for each job and epoch, else
  ``HOROVOD_COORDINATOR_PORT`` + 2, the JAX package's rule for its
  coordination service, else 9373).  With none set, the job is one
  process of size 1.
* An elastic job (``HOROVOD_ELASTIC``, set by the elastic driver) gives
  its process group a timeout of ``HOROVOD_ELASTIC_TIMEOUT`` seconds
  (default :data:`ELASTIC_TIMEOUT_S`): a collective that waits on a dead
  peer then ends.  Over gloo a dead peer surfaces at once anyway (the
  connection closes); over NCCL the collective would wait, and past the
  timeout the NCCL watchdog aborts the communicator and ends the
  process, whose exit the driver sees.
* :func:`reinit` is the elastic restart inside one process:
  :func:`shutdown`, then :func:`init` over the current environment, on
  the same device.
* Hosts: ``HOROVOD_CROSS_RANK`` / ``HOROVOD_CROSS_SIZE`` (default: rank
  // local size and size // local size).  :func:`init` gathers every
  rank's (cross rank, local rank, local size) and builds the local
  group (the ranks of this host) and the cross group (the ranks of this
  local rank on every host) with ``dist.new_group``, every group on
  every rank in one order; the JAX package's ``hierarchical_mesh``
  ``(cross, local)`` in process groups.  :func:`is_homogeneous` is
  true when every host has the same local size and ranks run host by
  host (``rank == cross_rank * local_size + local_rank``): the layout
  the hierarchical collectives need.
* :func:`init` starts the native control plane's eager runtime
  (:mod:`~horovod_tpu_torch.eager_runtime`) once the process group is
  up, unless ``HOROVOD_NATIVE=0``; :func:`shutdown` stops it.  A failed
  build or start raises (the JAX package falls back to its direct path).
  While it runs it owns the ``HOROVOD_TIMELINE`` file (rank 0, ``%r``
  expanded), as the JAX package's does; otherwise ``HOROVOD_TIMELINE``
  opens a :class:`~horovod_tpu_torch.timeline.Timeline` at init, held on
  the context (:func:`_open_timeline` has the JAX package's per-rank
  rules) and closed by :func:`shutdown`.  ``HOROVOD_AUTOTUNE`` creates
  the :class:`~horovod_tpu_torch.autotune.Autotuner` on the context.
* The backend follows the device: NCCL for CUDA (``cuda:local_rank``),
  gloo for ``device="cpu"``.  With no device and no CUDA, :func:`init`
  raises, as every entry point of the port does.
* The worker meshes, built at :func:`init` from the groups above as
  ``DeviceMesh`` objects on the job's device: :func:`mesh`, 1-D over the
  world with axis :func:`axis_name` (``init``'s ``axis_name``, default
  :data:`AXIS`: the GLOBAL communicator), and
  :func:`hierarchical_mesh`, ``(cross, local)`` when the job is
  homogeneous, else None.  :func:`sharding_for` places a spec over
  either; :func:`worker_index` reads this rank's place on an axis of the
  bound mesh (``parallel.bind``; ``spmd.shard`` binds one), a 0-dim
  int32 tensor on the job's device, as JAX's is read inside
  ``shard_map``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import timeline

__all__ = ["AXIS", "CROSS_AXIS", "ELASTIC_TIMEOUT_S", "LOCAL_AXIS",
           "NotInitializedError", "axis_name", "ccl_built", "cross_group",
           "cross_rank", "cross_size", "ddl_built", "device", "gloo_built",
           "gloo_enabled", "hierarchical_mesh", "init", "is_homogeneous",
           "is_initialized", "local_group", "local_rank", "local_size",
           "mesh", "mpi_built", "mpi_enabled", "mpi_threads_supported",
           "nccl_built", "num_processes", "process_rank", "rank", "reinit",
           "resolve_device", "sharding_for", "shutdown", "size",
           "worker_index", "xla_built"]

# The flat worker mesh's axis (the reference's GLOBAL communicator) and
# the hierarchical mesh's (its LOCAL and CROSS communicators), as in the
# JAX package.
AXIS: str = "hvd"
LOCAL_AXIS: str = "local"
CROSS_AXIS: str = "cross"

#: The process group's timeout in an elastic job, in seconds, unless
#: ``HOROVOD_ELASTIC_TIMEOUT`` says otherwise.
ELASTIC_TIMEOUT_S = 60.0


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: an explicit device is used as
    given; with none, CUDA — and no CUDA is an error, never a quiet fall
    back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: horovod_tpu_torch runs on the GPU unless the "
            "caller passes device='cpu'")
    return torch.device("cuda")


class NotInitializedError(RuntimeError):
    def __init__(self) -> None:
        super().__init__("horovod_tpu_torch has not been initialized; use "
                         "horovod_tpu_torch.basics.init().")


@dataclasses.dataclass(frozen=True)
class _Context:
    rank: int
    size: int
    local_rank: int
    local_size: int
    device: torch.device
    cross_rank: int
    cross_size: int
    homogeneous: bool
    # The process groups of this rank's host and of its local rank
    # across hosts (with their global ranks, in order).
    local_group: object
    cross_group: object
    local_ranks: Tuple[int, ...]
    cross_ranks: Tuple[int, ...]
    # The flat mesh's axis name (init's axis_name).
    axis_name: str = AXIS
    # The worker meshes (DeviceMesh): flat over the world, and (cross,
    # local) or None.
    mesh: object = None
    hierarchical_mesh: Optional[object] = None
    # The ``HOROVOD_TIMELINE`` timeline (horovod_tpu_torch.timeline
    # .Timeline), or None; ``timeline.get()`` reads it.
    timeline: Optional[object] = None
    # The ``HOROVOD_AUTOTUNE`` tuner (horovod_tpu_torch.autotune
    # .Autotuner), or None; ``ops.fusion`` reads its threshold.
    autotuner: Optional[object] = None


_context: Optional[_Context] = None


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v:
            try:
                return int(v)
            except ValueError:
                raise ValueError(f"environment variable {n}={v!r} is not "
                                 "an int") from None
    return None


def _coordinator() -> str:
    addr = os.environ.get("HOROVOD_COORDINATOR_ADDR") or "127.0.0.1"
    if ":" in addr:
        return f"tcp://{addr}"
    port = _env_int("HOROVOD_STORE_PORT")
    if port is None:
        base = _env_int("HOROVOD_COORDINATOR_PORT")
        port = base + 2 if base is not None else 9373
    return f"tcp://{addr}:{port}"


def _elastic() -> bool:
    return os.environ.get("HOROVOD_ELASTIC", "0") not in ("", "0", "false")


def _pg_timeout() -> dict:
    """``init_process_group``'s timeout keyword: an elastic job's
    (:data:`ELASTIC_TIMEOUT_S`), else torch's default."""
    if not _elastic():
        return {}
    v = os.environ.get("HOROVOD_ELASTIC_TIMEOUT")
    return {"timeout": datetime.timedelta(
        seconds=float(v) if v else ELASTIC_TIMEOUT_S)}


def init(*, device=None, init_method: Optional[str] = None,
         axis_name: str = AXIS) -> None:
    """Join the job's process group.  Idempotent.

    ``init_method`` (a ``torch.distributed`` URL such as
    ``tcp://127.0.0.1:29500``) overrides the coordinator from the
    environment; a size-1 job without one uses an in-process store.
    ``axis_name`` names the flat mesh's axis (:func:`axis_name`), the
    world's name for every collective's ``axis_name``."""
    global _context
    if _context is not None:
        return
    size = _env_int("HOROVOD_SIZE", "HOROVOD_NUM_PROC") or 1
    rank = _env_int("HOROVOD_RANK") or 0
    if not 0 <= rank < size:
        raise ValueError(f"HOROVOD_RANK {rank} is outside a job of {size}")
    lrank = _env_int("HOROVOD_LOCAL_RANK")
    lsize = _env_int("HOROVOD_LOCAL_SIZE")
    lrank = rank if lrank is None else lrank
    lsize = size if lsize is None else lsize
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", lrank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    if init_method is None and size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **_pg_timeout())
    else:
        dist.init_process_group(backend, init_method=init_method
                                or _coordinator(), rank=rank,
                                world_size=size, **_pg_timeout())
    crank = _env_int("HOROVOD_CROSS_RANK")
    csize = _env_int("HOROVOD_CROSS_SIZE")
    crank = rank // lsize if crank is None else crank
    csize = max(size // lsize, 1) if csize is None else csize
    layout = _gather_layout(rank, size, crank, lrank, lsize, dev)
    homogeneous = (len({ls for _, _, ls in layout}) == 1
                   and csize * lsize == size
                   and all(r == c * lsize + l
                           for r, (c, l, _) in enumerate(layout)))
    local, lranks = _groups(layout, 0, crank)
    cross, cranks = _groups(layout, 1, lrank)
    flat, hier = _meshes(dev, size, csize, lsize, homogeneous, local, cross,
                         axis_name)
    _context = _Context(rank, size, lrank, lsize, dev, crank, csize,
                        homogeneous, local, cross, lranks, cranks, axis_name,
                        flat, hier)
    # The native control plane's eager runtime (negotiation, fusion, the
    # response cache, the stall inspector) over this process group.
    from horovod_tpu_torch import eager_runtime

    tl_path = timeline.expand_rank_path(
        os.environ.get("HOROVOD_TIMELINE", ""), rank)
    try:
        native_rt = eager_runtime.start(timeline_path=tl_path)
    except BaseException:
        _context = None
        dist.destroy_process_group()
        raise
    # When the runtime is up it owns the HOROVOD_TIMELINE file (rank 0);
    # the Python Timeline otherwise.
    tl = _open_timeline(rank, size) if native_rt is None else None
    tuner = None
    if os.environ.get("HOROVOD_AUTOTUNE", "0") not in ("", "0", "false"):
        from horovod_tpu_torch.autotune import Autotuner

        tuner = Autotuner.from_env()
    _context = dataclasses.replace(_context, timeline=tl, autotuner=tuner)
    # Seeded so a /metrics scrape exposes the family before any
    # timeline exists.
    timeline._dropped_events_counter()


def _open_timeline(rank: int, size: int):
    """The ``HOROVOD_TIMELINE`` timeline of this rank, the JAX package's
    rules: a path with ``%r`` gives every rank its own file (merge them
    with ``python -m horovod_tpu_torch.obs.merge``); an elastic job of
    more than one process suffixes the path with the rank (respawning
    ranks writing one path would clobber each other's traces);
    otherwise rank 0 alone writes it."""
    path = os.environ.get("HOROVOD_TIMELINE")
    if not path:
        return None
    if "%r" in path:
        return timeline.Timeline(timeline.expand_rank_path(path, rank))
    if _elastic() and size > 1:
        root, ext = os.path.splitext(path)
        return timeline.Timeline(f"{root}.rank{rank}{ext or '.json'}")
    if rank == 0:
        return timeline.Timeline(path)
    return None


def _gather_layout(rank, size, crank, lrank, lsize, dev) -> List[tuple]:
    """Every rank's ``(cross rank, local rank, local size)``, by rank."""
    if size == 1:
        return [(crank, lrank, lsize)]
    mine = torch.tensor([crank, lrank, lsize], dtype=torch.int64, device=dev)
    parts = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(parts, mine)
    return [tuple(int(v) for v in p.tolist()) for p in parts]


def _groups(layout, field: int, mine: int):
    """One ``dist.new_group`` per distinct value of ``layout[r][field]``
    (its ranks in rank order), made in ascending order on every rank ->
    (the group holding value ``mine``, its ranks)."""
    ours = None
    for value in sorted({entry[field] for entry in layout}):
        ranks = tuple(r for r, entry in enumerate(layout)
                      if entry[field] == value)
        group = dist.new_group(list(ranks))
        if value == mine:
            ours = (group, ranks)
    return ours


def _meshes(dev, size, csize, lsize, homogeneous, local, cross, axis_name):
    """The flat mesh (axis ``axis_name``) over the world group and, for a
    homogeneous job, the ``(cross, local)`` mesh over the cross and local
    groups (rank ``r`` at ``(r // local size, r % local size)``); no new
    group is made."""
    from torch.distributed.device_mesh import DeviceMesh

    flat = DeviceMesh.from_group(dist.group.WORLD, dev.type,
                                 mesh_dim_names=(axis_name,))
    if not homogeneous:
        return flat, None
    hier = DeviceMesh.from_group(
        [cross, local], dev.type, mesh=torch.arange(size).reshape(
            csize, lsize), mesh_dim_names=(CROSS_AXIS, LOCAL_AXIS))
    return flat, hier


def shutdown() -> None:
    """Stop the eager runtime, close the ``HOROVOD_TIMELINE`` timeline and
    leave the process group and its local and cross groups (a later
    :func:`init` may join again)."""
    global _context
    if _context is None:
        return
    from horovod_tpu_torch import eager_runtime

    eager_runtime.stop()
    if _context.timeline is not None:
        _context.timeline.close()
    from horovod_tpu_torch.parallel import meshes

    meshes.forget_axes_groups()
    dist.destroy_process_group()
    _context = None


def reinit(*, device=None, axis_name: Optional[str] = None) -> None:
    """Tear down and re-initialize the process group (the elastic restart
    path of ``elastic.run`` in a one-process job): :func:`shutdown`, which
    destroys the process groups, then :func:`init` over the current
    environment, on ``device`` (default: the device this process drives
    now), with the flat axis named ``axis_name`` (default: the current
    name).  Counts ``elastic_rendezvous_total`` and marks the timeline, as
    the JAX package's ``reinit`` does.  A job of several processes cannot
    re-rendezvous in-process; the elastic driver respawns its ranks with
    a fresh epoch's environment instead."""
    if _context is not None:
        device = _context.device if device is None else device
        axis_name = _context.axis_name if axis_name is None else axis_name
    shutdown()
    init(device=device, axis_name=axis_name or AXIS)
    try:
        from horovod_tpu_torch.obs import tracing as obs_tracing
        from horovod_tpu_torch.obs.registry import elastic_metrics

        elastic_metrics().rendezvous.inc()
        obs_tracing.instant("elastic_rerendezvous", {
            "epoch": os.environ.get("HOROVOD_ELASTIC_EPOCH"),
            "size": size()})
    except Exception:  # pragma: no cover - metrics never gate recovery
        pass


def is_initialized() -> bool:
    return _context is not None


def _ctx() -> _Context:
    if _context is None:
        raise NotInitializedError()
    return _context


def size() -> int:
    return _ctx().size


def rank() -> int:
    return _ctx().rank


def local_rank() -> int:
    return _ctx().local_rank


def local_size() -> int:
    return _ctx().local_size


def device() -> torch.device:
    """The device this process drives."""
    return _ctx().device


def cross_rank() -> int:
    """This rank's host index (``horovod_cross_rank``)."""
    return _ctx().cross_rank


def cross_size() -> int:
    """The number of hosts (``horovod_cross_size``)."""
    return _ctx().cross_size


def is_homogeneous() -> bool:
    """True if every host runs the same number of ranks, host by host
    (``horovod_is_homogeneous``)."""
    return _ctx().homogeneous


def local_group():
    """The process group of this host's ranks (the JAX ``local`` axis)."""
    return _ctx().local_group


def cross_group():
    """The process group of this local rank on every host (the JAX
    ``cross`` axis)."""
    return _ctx().cross_group


def mesh():
    """The flat worker mesh: a 1-D ``DeviceMesh`` over the world with
    axis :func:`axis_name` (the GLOBAL communicator)."""
    return _ctx().mesh


def hierarchical_mesh():
    """The 2-D ``(cross, local)`` mesh, or None when hosts are
    heterogeneous (:func:`is_homogeneous`): the reference's LOCAL and
    CROSS communicators as mesh axes."""
    return _ctx().hierarchical_mesh


def axis_name() -> str:
    """The flat mesh's axis name: ``init``'s ``axis_name``, default
    :data:`AXIS`."""
    return _ctx().axis_name


def sharding_for(spec, *, hierarchical: bool = False):
    """A :class:`~horovod_tpu_torch.parallel.sharding.NamedSharding` of
    ``spec`` over the flat (or the hierarchical) mesh."""
    from horovod_tpu_torch.parallel.sharding import NamedSharding

    m = hierarchical_mesh() if hierarchical else mesh()
    if m is None:
        raise ValueError("hierarchical mesh unavailable (heterogeneous hosts)")
    return NamedSharding(m, spec)


def worker_index(axis: Optional[str] = None) -> torch.Tensor:
    """This rank's index along ``axis`` (default :func:`axis_name`) of the
    bound mesh, a 0-dim int32 tensor on the job's device.  Only valid
    under a binding (``parallel.bind``, ``spmd.shard``): outside one it
    raises the unbound-axis ``NameError``, as JAX's does outside
    ``shard_map``."""
    from horovod_tpu_torch.parallel import meshes

    ctx = _ctx()
    return torch.tensor(meshes.axis_index(axis or ctx.axis_name),
                        dtype=torch.int32, device=ctx.device)


def process_rank() -> int:
    """This process's rank: one process drives one device, so
    :func:`rank`."""
    return _ctx().rank


def num_processes() -> int:
    """The job's processes: :func:`size`, one a device."""
    return _ctx().size


# --- build-capability introspection (the JAX package's basics.py:446-506,
# the reference's mpi_built / gloo_built / nccl_built ...) --------------------

def _backend() -> Optional[str]:
    return dist.get_backend() if _context is not None else None


def mpi_enabled() -> bool:
    return _backend() == "mpi"


def mpi_built() -> bool:
    return dist.is_mpi_available()


def gloo_enabled() -> bool:
    """True when the job's process group runs over gloo (``device="cpu"``)."""
    return _backend() == "gloo"


def gloo_built() -> bool:
    return dist.is_gloo_available()


def nccl_built() -> bool:
    return dist.is_nccl_available()


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def xla_built() -> bool:
    """The port runs no XLA collectives."""
    return False


def mpi_threads_supported() -> bool:
    return False
