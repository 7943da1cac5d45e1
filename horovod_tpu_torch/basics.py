"""Process topology over ``torch.distributed``: init, rank and size.

Counterpart of ``horovod_tpu/basics.py``.  A worker is one process
driving one device (the JAX package drives every local chip from one
process; PyTorch's idiom is a process per GPU).

* Rank and size come from the launcher's environment, as in the JAX
  package's ``_bootstrap_distributed``: ``HOROVOD_RANK``,
  ``HOROVOD_SIZE`` (or ``HOROVOD_NUM_PROC``), ``HOROVOD_LOCAL_RANK`` /
  ``HOROVOD_LOCAL_SIZE`` (default: one host) and
  ``HOROVOD_COORDINATOR_ADDR`` (``host`` or ``host:port``; without a
  port, ``HOROVOD_COORDINATOR_PORT`` + 2, the JAX package's rule, else
  9373).  With none set, the job is one process of size 1.
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
* ``HOROVOD_TIMELINE`` opens a :class:`~horovod_tpu_torch.timeline.
  Timeline` at init, held on the context (:func:`_open_timeline` has
  the JAX package's per-rank rules) and closed by :func:`shutdown`.
* The backend follows the device: NCCL for CUDA (``cuda:local_rank``),
  gloo for ``device="cpu"``.  With no device and no CUDA, :func:`init`
  raises, as every entry point of the port does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import timeline

__all__ = ["NotInitializedError", "cross_group", "cross_rank", "cross_size",
           "device", "init", "is_homogeneous", "is_initialized",
           "local_group", "local_rank", "local_size", "rank",
           "resolve_device", "shutdown", "size"]


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
    # across hosts (with the cross group's global ranks, in order).
    local_group: object
    cross_group: object
    cross_ranks: Tuple[int, ...]
    # The ``HOROVOD_TIMELINE`` timeline (horovod_tpu_torch.timeline
    # .Timeline), or None; ``timeline.get()`` reads it.
    timeline: Optional[object] = None


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
    base = _env_int("HOROVOD_COORDINATOR_PORT")
    return f"tcp://{addr}:{base + 2 if base is not None else 9373}"


def init(*, device=None, init_method: Optional[str] = None) -> None:
    """Join the job's process group.  Idempotent.

    ``init_method`` (a ``torch.distributed`` URL such as
    ``tcp://127.0.0.1:29500``) overrides the coordinator from the
    environment; a size-1 job without one uses an in-process store."""
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
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method
                                or _coordinator(), rank=rank,
                                world_size=size)
    crank = _env_int("HOROVOD_CROSS_RANK")
    csize = _env_int("HOROVOD_CROSS_SIZE")
    crank = rank // lsize if crank is None else crank
    csize = max(size // lsize, 1) if csize is None else csize
    layout = _gather_layout(rank, size, crank, lrank, lsize, dev)
    homogeneous = (len({ls for _, _, ls in layout}) == 1
                   and csize * lsize == size
                   and all(r == c * lsize + l
                           for r, (c, l, _) in enumerate(layout)))
    local, _ = _groups(layout, 0, crank)
    cross, cranks = _groups(layout, 1, lrank)
    _context = _Context(rank, size, lrank, lsize, dev, crank, csize,
                        homogeneous, local, cross, cranks,
                        _open_timeline(rank, size))
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
    elastic = os.environ.get("HOROVOD_ELASTIC", "0") not in ("", "0",
                                                            "false")
    if "%r" in path:
        return timeline.Timeline(timeline.expand_rank_path(path, rank))
    if elastic and size > 1:
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


def shutdown() -> None:
    """Close the ``HOROVOD_TIMELINE`` timeline and leave the process
    group and its local and cross groups (a later :func:`init` may join
    again)."""
    global _context
    if _context is None:
        return
    if _context.timeline is not None:
        _context.timeline.close()
    dist.destroy_process_group()
    _context = None


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
