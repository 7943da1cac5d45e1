"""The data-parallel train step.

Counterpart of ``horovod_tpu/spmd.py`` ``make_train_step``.  Where the
JAX package compiles forward, backward, gradient allreduce and update
into one SPMD program, PyTorch runs them eagerly in one process per
device: every rank calls ``step`` with its own shard of the batch, and
the optimizer (a :func:`~horovod_tpu_torch.optim.DistributedOptimizer`)
reduces the gradients before its update.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from horovod_tpu_torch.ops import collectives as C

__all__ = ["make_train_step"]


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer
                    ) -> Callable:
    """``loss_fn(params, batch) -> scalar loss`` and an optimizer over
    the tensors of ``params`` -> ``step(params, batch) -> loss``: zero
    the gradients, forward, backward, the optimizer's step (parameters
    are updated in place), and return the loss averaged over the
    ranks."""

    def step(params: Dict, batch: Dict) -> torch.Tensor:
        optimizer.zero_grad()
        loss = loss_fn(params, batch)
        loss.backward()
        optimizer.step()
        return C.allreduce(loss.detach(), C.Average)

    return step
