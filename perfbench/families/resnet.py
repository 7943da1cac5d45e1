"""ResNet cells: the weights and batches the benchmark makes, the program's
train step over them, and the plain reference's three steps.

The program is ``horovod_tpu_torch``'s ResNet (``models/resnet.py``: bf16
compute over f32 parameters and f32 BatchNorm statistics, channels_last)
trained with SGD and momentum (``program_dtype``, a key only a look at the
comparison sets, runs it in float32), on the path a traffic file names
(``perfbench/paths/``).  On ``world`` ranks each rank trains on its own
slice of every batch, with BatchNorm's statistics its own, as data-parallel
training without synchronised BatchNorm does.

Weights follow torchvision's initialisation (He-normal convolutions by
fan-out, unit BatchNorm scales, the classifier uniform in ±1/√fan-in),
drawn on the device from the seed in two calls.  Images are standard
normal, labels uniform over the classes, as the synthetic benchmark draws
them, ``pool`` batches of them on the device.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Iterator, Tuple

import torch

from perfbench import paths
from perfbench.check import Readings, change_norms, leaf_norms
from perfbench.reference import optim as ref_optim
from perfbench.reference import resnet as ref

UNIT = "img"


def _seed(seed: int, what: str) -> int:
    return (seed * 1_000_003 + zlib.crc32(what.encode())) % (1 << 63)


def _gen(device, seed: int, what: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, what))
    return g


def weights(config: Dict, seed: int, device
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(parameters, buffers)`` in float32 under the program's names."""
    lay = ref.layout(config)
    convs = [(n, s) for n, (k, s) in lay.items() if k == "conv"]
    fc = [(n, s) for n, (k, s) in lay.items() if k.startswith("fc")]
    flat = torch.randn(sum(math.prod(s) for _, s in convs),
                       generator=_gen(device, seed, "conv"), device=device)
    params, at = {}, 0
    for n, s in convs:
        k = math.prod(s)
        # kaiming_normal_(mode="fan_out", nonlinearity="relu")
        params[n] = flat[at:at + k].view(s) * math.sqrt(
            2.0 / (s[0] * s[2] * s[3]))
        at += k
    bound = 1.0 / math.sqrt(lay["head.weight"][1][1])
    u = torch.rand(sum(math.prod(s) for _, s in fc),
                   generator=_gen(device, seed, "fc"), device=device)
    at = 0
    for n, s in fc:
        k = math.prod(s)
        params[n] = u[at:at + k].view(s).mul(2 * bound).sub_(bound)
        at += k
    buffers = {}
    for n, (kind, s) in lay.items():
        if kind in ("bn_w", "var"):
            (params if kind == "bn_w" else buffers)[n] = torch.ones(
                s, device=device)
        elif kind in ("bn_b", "mean"):
            (params if kind == "bn_b" else buffers)[n] = torch.zeros(
                s, device=device)
    order = list(lay)
    return ({n: params[n] for n in order if n in params},
            {n: buffers[n] for n in order if n in buffers})


def batches(config: Dict, traffic: Dict, seed: int, device, rank: int = 0,
            world: int = 1):
    """``pool`` batches, rank ``rank``'s slice of each of ``world``:
    bf16 images in channels_last, int64 labels."""
    B, P, S = traffic["batch"], traffic["pool"], config["image_size"]
    g = _gen(device, seed, "data")
    images = torch.randn((P, B * world, 3, S, S), generator=g,
                         device=device).to(torch.bfloat16)
    labels = torch.randint(0, config["num_classes"], (P, B * world),
                           generator=g, device=device)
    rows = slice(rank * B, (rank + 1) * B)
    return [{"images": images[i, rows].contiguous(
        memory_format=torch.channels_last), "labels": labels[i, rows]}
        for i in range(P)]


def initial_state(config: Dict, seed: int, device
                  ) -> Iterator[Tuple[str, torch.Tensor]]:
    params, buffers = weights(config, seed, device)
    yield from params.items()
    yield from buffers.items()


def split(name: str, t: torch.Tensor):
    return [(name, t)]


def kinds(config: Dict) -> Dict[str, str]:
    """Leaf -> its kind, for ``check``'s ``change.<kind>``: ``conv``,
    ``bn_w``, ``bn_b``, ``mean``, ``var``, ``head``."""
    return {n: "head" if k.startswith("fc") else k
            for n, (k, _) in ref.layout(config).items()}


def items_per_step(traffic: Dict) -> Dict[str, int]:
    return {UNIT: traffic["batch"]}


class Program:
    """The program's model and train step over the benchmark's weights and
    batches."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 rank: int = 0, world: int = 1):
        import torch.nn.functional as F

        from horovod_tpu_torch.models import resnet

        if torch.device(device).type == "cuda":
            torch.backends.cudnn.benchmark = True
        self.items_per_step = items_per_step(traffic)
        self.spans: Dict[str, list] = {}
        model = resnet.ResNet(config["stage_sizes"], resnet.BottleneckBlock,
                              num_classes=config["num_classes"],
                              num_filters=config["num_filters"],
                              dtype=getattr(torch, config.get(
                                  "program_dtype", "bfloat16")),
                              stem="conv7")
        params, buffers = weights(config, seed, device)
        model.to(device).load_state_dict({**params, **buffers})
        del params, buffers
        self.model = model.to(memory_format=torch.channels_last).train()
        self.batches = batches(config, traffic, seed, device, rank, world)
        opt = config["optimizer"]
        inner = torch.optim.SGD(self.model.parameters(), lr=opt["lr"],
                                momentum=opt["momentum"])

        def loss_fn(m, b):
            return F.cross_entropy(m(b["images"]), b["labels"])

        self.opt, self._run = paths.load(traffic["path"]).make(
            self.model, inner, loss_fn, list(self.model.named_parameters()),
            self.spans)

    def step(self, i: int) -> torch.Tensor:
        return self._run(self.batches[i % len(self.batches)])

    def first_grads(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """The gradient of the first step, as SGD holds it: its momentum
        buffer after one step is that gradient."""
        for name, p in self.model.named_parameters():
            st = self.opt.state.get(p, {})
            yield name, st.get("momentum_buffer", torch.zeros_like(p))

    def state(self) -> Iterator[Tuple[str, torch.Tensor]]:
        yield from self.model.named_parameters()
        yield from self.model.named_buffers()

    def free(self) -> None:
        self.model = self.opt = self._run = self.batches = None


def reference(config: Dict, traffic: Dict, seed: int, device, prec,
              fault: str = None, steps: int = 3, world: int = 1,
              loss_over: str = "rank"):
    """The plain reference's first ``steps`` steps, from the same weights
    and batches, as rank 0 of ``world`` sees them (the gradient averaged
    over the ranks' slices, BatchNorm's running statistics rank 0's; the
    loss rank 0's, or with ``loss_over`` ``"world"`` the ranks' mean) ->
    :class:`perfbench.check.Readings`.  ``fault``: ``half_batch`` takes
    each loss over the first half of each slice."""
    params, buffers = weights(config, seed, device)
    shards = [batches(config, traffic, seed, device, r, world)
              for r in range(world)]
    P = len(shards[0])
    names = list(params)
    for p in params.values():
        p.requires_grad_()
    opt = ref_optim.make(config["optimizer"], list(params.values()))
    losses, grad, grad_max = [], None, {}
    for i in range(steps):
        grads, step_losses = None, []
        for r in range(world):
            batch = shards[r][i % P]
            x, y = batch["images"], batch["labels"]
            if fault == "half_batch":
                x, y = x[:len(y) // 2], y[:len(y) // 2]
            logits, stats = ref.forward(params, x, config, prec)
            loss = ref.cross_entropy(logits, y)
            g = torch.autograd.grad(loss / world, [params[n] for n in names])
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            step_losses.append(float(loss.detach()))
            if r == 0:
                ref.move_running(buffers, stats)
            del logits, stats, loss, g
        losses.append(step_losses[0] if loss_over == "rank"
                      else sum(step_losses) / world)
        norms = leaf_norms(zip(names, grads), split)
        grad = grad or norms
        grad_max = {k: max(v, grad_max.get(k, 0.0)) for k, v in norms.items()}
        opt.step(grads)
        del grads
    now = {**params, **buffers}
    change = change_norms(now.items(), initial_state(config, seed, device),
                          split)
    return Readings(losses, grad, change, grad_max)
