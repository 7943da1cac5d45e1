"""Plain optimizers for the references, written from their published
update rules (PyTorch's documented forms), over lists of float32 tensors.
"""

from __future__ import annotations

from typing import List

import torch


class SGD:
    """Heavy-ball momentum without dampening: ``b = g`` at the first step,
    then ``b = m · b + g``; ``p -= lr · b``."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 momentum: float):
        self.params, self.lr, self.momentum = params, lr, momentum
        self.buf = [None] * len(params)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if self.buf[i] is None:
                self.buf[i] = g.clone()
            else:
                self.buf[i].mul_(self.momentum).add_(g)
            p.sub_(self.buf[i], alpha=self.lr)


class AdamW:
    """Decoupled weight decay (Loshchilov and Hutter): ``p *= 1 - lr · wd``;
    ``m, v`` moved by ``betas``; ``p -= lr · m̂ / (sqrt(v̂) + eps)``, with
    the bias corrections of step ``t``."""

    def __init__(self, params: List[torch.Tensor], lr: float, betas,
                 eps: float, weight_decay: float):
        self.params, self.lr, self.eps, self.wd = params, lr, eps, weight_decay
        self.b1, self.b2 = betas
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (v / c2).sqrt_().add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)
            del denom


def make(spec: dict, params: List[torch.Tensor]):
    """The optimizer a configuration's ``optimizer`` entry names."""
    kind = spec["name"]
    if kind == "sgd":
        return SGD(params, spec["lr"], spec["momentum"])
    if kind == "adamw":
        return AdamW(params, spec["lr"], tuple(spec["betas"]), spec["eps"],
                     spec["weight_decay"])
    raise ValueError(f"no plain optimizer {kind!r}")
