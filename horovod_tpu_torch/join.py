"""Join: ranks that run out of data before the others.

Counterpart of ``horovod_tpu/join.py``.  Every rank keeps making every
collective; a rank that has run out of data is inactive and contributes
zeros, and the average divides by the live count (:func:`masked_average`,
the reference's zero-tensor substitution).  :func:`masked_average` is
the JAX package's in-graph form, so its collectives run directly, never
through the eager runtime.  :func:`join` is the reference's JOIN through
the native control plane: while a rank waits in it, the other ranks'
allreduces go on with it contributing zeros, and every rank gets the
rank that joined last.  Under ``HOROVOD_NATIVE=0`` it is the JAX
package's fallback, an allreduce-Max of the rank.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collectives as C

__all__ = ["join", "masked_average"]


def masked_average(grads: Union[torch.Tensor, Sequence[torch.Tensor]],
                   active, *,
                   axis_name=None) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Average ``grads`` (a tensor or a list) over the ranks whose
    ``active`` (a 0/1 flag) is set: an inactive rank contributes zeros,
    and the divisor is the live count clamped to 1, so a step where
    every rank has joined returns zeros, not NaN.  ``axis_name``: the
    ranks of that axis or tuple of axes only (the live count and the
    sums over its group; ``collectives.allreduce``'s)."""
    single = torch.is_tensor(grads)
    tensors = [grads] if single else list(grads)
    dev = tensors[0].device if tensors else basics.device()
    a = torch.as_tensor(active, dtype=torch.float32, device=dev).reshape(())
    with C._direct_path():
        live = C.allreduce(a, C.Sum, axis_name=axis_name).clamp_min(1.0)
        out = [C.allreduce_(g * a.to(g.dtype), C.Sum,
                            axis_name=axis_name).div_(live.to(g.dtype))
               for g in tensors]
    return out[0] if single else out


def join() -> int:
    """Block until every process has called ``join``; returns the last
    joining rank (the reference returns the last joined rank so callers
    can broadcast final state from it).

    With the native runtime this is the reference's true JOIN protocol
    (``EnqueueJoin`` ``operations.cc:919-943``): while blocked here, other
    ranks' allreduces proceed with this rank contributing zeros; the
    coordinator tracks join ARRIVAL ORDER and releases everyone once all
    ranks joined, distributing the last-joined rank in the JOIN response.

    Without it (``HOROVOD_NATIVE=0``) there is no arrival-order observer:
    the fallback is an allreduce-Max of the rank, size - 1 on every
    rank."""
    basics._ctx()
    from horovod_tpu_torch import eager_runtime

    rt = eager_runtime.get()
    if rt is not None:
        return int(rt.join())
    my = torch.tensor(float(basics.rank()), dtype=torch.float32,
                      device=basics.device())
    return int(C.allreduce(my, C.Max))
