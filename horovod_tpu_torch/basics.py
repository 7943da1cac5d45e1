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
* The backend follows the device: NCCL for CUDA (``cuda:local_rank``),
  gloo for ``device="cpu"``.  With no device and no CUDA, :func:`init`
  raises, as every entry point of the port does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["NotInitializedError", "device", "init", "is_initialized",
           "local_rank", "local_size", "rank", "resolve_device", "shutdown",
           "size"]


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
    _context = _Context(rank, size, lrank, lsize, dev)


def shutdown() -> None:
    """Leave the process group (a later :func:`init` may join again)."""
    global _context
    if _context is None:
        return
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
