"""Join: ranks that run out of data before the others.

Counterpart of ``horovod_tpu/join.py``.  Every rank keeps making every
collective; a rank that has run out of data is inactive and contributes
zeros, and the average divides by the live count (:func:`masked_average`,
the reference's zero-tensor substitution).  :func:`join` is the JAX
package's fallback without its native control plane: an allreduce-Max of
the rank, which returns once every rank has called it.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collectives as C

__all__ = ["join", "masked_average"]


def masked_average(grads: Union[torch.Tensor, Sequence[torch.Tensor]],
                   active) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Average ``grads`` (a tensor or a list) over the ranks whose
    ``active`` (a 0/1 flag) is set: an inactive rank contributes zeros,
    and the divisor is the live count clamped to 1, so a step where
    every rank has joined returns zeros, not NaN."""
    single = torch.is_tensor(grads)
    tensors = [grads] if single else list(grads)
    dev = tensors[0].device if tensors else basics.device()
    a = torch.as_tensor(active, dtype=torch.float32, device=dev).reshape(())
    live = C.allreduce(a, C.Sum).clamp_min(1.0)
    out = [C.allreduce_(g * a.to(g.dtype), C.Sum).div_(live.to(g.dtype))
           for g in tensors]
    return out[0] if single else out


def join() -> int:
    """Block until every rank has called ``join``; returns the highest
    rank (the JAX fallback's allreduce-Max of the rank: size - 1 on
    every rank)."""
    my = torch.tensor(float(basics.rank()), dtype=torch.float32,
                      device=basics.device())
    return int(C.allreduce(my, C.Max))
