"""Small MLP classifier, the counterpart of ``horovod_tpu/models/mlp.py``
(the MNIST example model): plain functions on a dict of tensors, ``w{i}``
``(in, out)`` and ``b{i}`` ``(out,)``, the JAX package's layout."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from horovod_tpu_torch.basics import resolve_device

__all__ = ["accuracy", "forward", "init_params", "loss_fn"]


def init_params(sizes: Sequence[int] = (784, 256, 128, 10), *,
                seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """``w{i}`` normal over ``sqrt(in)``, ``b{i}`` zeros, f32, drawn on
    ``device`` (CUDA unless ``"cpu"`` is passed) from a
    ``torch.Generator`` seeded with ``seed``."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = torch.randn((a, b), generator=g,
                                      device=device) / math.sqrt(a)
        params[f"b{i}"] = torch.zeros((b,), device=device)
    return params


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    n = len(params) // 2
    h = x.reshape(x.shape[0], -1)
    for i in range(n):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def loss_fn(params: Dict[str, torch.Tensor], batch) -> torch.Tensor:
    """Mean softmax cross-entropy of ``batch = (x, y)``."""
    x, y = batch
    logits = forward(params, x)
    gold = logits.gather(-1, y[:, None].long()).squeeze(-1)
    return (torch.logsumexp(logits, -1) - gold).mean()


def accuracy(params: Dict[str, torch.Tensor], batch) -> torch.Tensor:
    x, y = batch
    return (forward(params, x).argmax(-1) == y).float().mean()
