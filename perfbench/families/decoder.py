"""Decoder-LM cells: the weights and batches the benchmark makes, the
program's train step over them, and the plain reference's three steps.

The program is ``horovod_tpu_torch``'s Transformer (``models/transformer.py``
with ``attention_impl="flash"``: bf16 compute over f32 master weights, the
attention forward and backward in the port's kernels K1-K3), trained with
AdamW on the path a traffic file names (``perfbench/paths/``; the LM's
cells run ``captured``).  On ``world`` ranks each rank trains on its own
rows of every batch.

Weights follow the Hugging Face initialisation of the family (every
matrix and the embedding normal with ``initializer_range``, unit norm
scales), each tensor drawn on the device from its own generator, so that
one can be drawn again alone.  Tokens are uniform over the vocabulary,
each row ``seq + 1`` long, the last ``seq`` its targets.
"""

from __future__ import annotations

import zlib
from typing import Dict, Iterator, Tuple

import torch

from perfbench import paths
from perfbench.check import Readings, change_norms, leaf_norms
from perfbench.reference import decoder as ref
from perfbench.reference import optim as ref_optim

UNIT = "tokens"


def _gen(device, seed: int, what: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + zlib.crc32(what.encode())) % (1 << 63))
    return g


def _tensor(config: Dict, seed: int, device, name: str) -> torch.Tensor:
    shape = ref.shapes(config)[name]
    if name.split(".")[-1] in ("ln1", "ln2", "ln_f"):
        return torch.ones(shape, device=device)
    return torch.randn(shape, generator=_gen(device, seed, name),
                       device=device).mul_(config["initializer_range"])


def initial_state(config: Dict, seed: int, device
                  ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every weight in float32 under the program's names, one at a time."""
    for name in ref.shapes(config):
        yield name, _tensor(config, seed, device, name)


def batches(config: Dict, traffic: Dict, seed: int, device, rank: int = 0,
            world: int = 1):
    """``pool`` batches, rank ``rank``'s rows of each of ``world``."""
    B, S, P = traffic["batch"], traffic["seq"], traffic["pool"]
    rows = torch.randint(0, config["vocab_size"], (P, B * world, S + 1),
                         generator=_gen(device, seed, "data"), device=device)
    rows = rows[:, rank * B:(rank + 1) * B]
    return [{"tokens": rows[i, :, :S].contiguous(),
             "targets": rows[i, :, 1:].contiguous()} for i in range(P)]


def split(name: str, t: torch.Tensor):
    if name.startswith("layers."):
        return [(f"{name}.{l}", t[l]) for l in range(t.shape[0])]
    return [(name, t)]


def items_per_step(traffic: Dict) -> Dict[str, int]:
    return {UNIT: traffic["batch"] * traffic["seq"]}


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    out = {"layers": {}}
    for name, t in flat.items():
        if name.startswith("layers."):
            out["layers"][name.split(".", 1)[1]] = t
        else:
            out[name] = t
    return out


def port_config(config: Dict, traffic: Dict):
    """The program's ``TransformerConfig`` for a configuration."""
    from horovod_tpu_torch.models import transformer as T

    if config["rms_norm_eps"] != 1e-6:
        raise ValueError("the program's RMSNorm epsilon is 1e-6; a "
                         "configuration must run with that value")
    c = config
    return T.TransformerConfig(
        vocab_size=c["vocab_size"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_layers=c["num_hidden_layers"],
        d_ff=c["intermediate_size"], max_seq=traffic["seq"],
        n_kv_heads=c["num_key_value_heads"], rope_theta=c["rope_theta"],
        dtype=torch.bfloat16, attention_impl="flash")


class Program:
    """The program's parameters and captured train step over the
    benchmark's weights and batches."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 rank: int = 0, world: int = 1):
        from horovod_tpu_torch.models import transformer as T

        cfg = port_config(config, traffic)
        self.items_per_step = items_per_step(traffic)
        self.spans: Dict[str, list] = {}
        self.flat = dict(initial_state(config, seed, device))
        for t in self.flat.values():
            t.requires_grad_()
        self.params = _nest(self.flat)
        self.batches = batches(config, traffic, seed, device, rank, world)
        o = config["optimizer"]
        inner = torch.optim.AdamW(list(self.flat.values()), lr=o["lr"],
                                  betas=tuple(o["betas"]), eps=o["eps"],
                                  weight_decay=o["weight_decay"])
        self.beta1 = o["betas"][0]
        self.opt, self.train = paths.load(traffic["path"]).make(
            self.params, inner, lambda p, b: T.loss_fn(p, b, cfg),
            list(self.flat.items()), self.spans)

    def step(self, i: int) -> torch.Tensor:
        return self.train(self.batches[i % len(self.batches)])

    def first_grads(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """The gradient of the first step, as AdamW holds it: its first
        moment after one step is ``(1 − β1) · g``."""
        for name, p in self.flat.items():
            m = self.opt.state.get(p, {}).get("exp_avg")
            yield name, (torch.zeros_like(p) if m is None
                         else m / (1 - self.beta1))

    def state(self) -> Iterator[Tuple[str, torch.Tensor]]:
        yield from self.flat.items()

    def free(self) -> None:
        self.flat = self.params = self.opt = self.train = self.batches = None


def reference(config: Dict, traffic: Dict, seed: int, device, prec,
              fault: str = None, steps: int = 3, world: int = 1,
              loss_over: str = "rank"):
    """The plain reference's first ``steps`` steps, from the same weights
    and batches, as rank 0 of ``world`` sees them (the gradient averaged
    over the ranks' rows; the loss rank 0's, or with ``loss_over``
    ``"world"`` the ranks' mean) -> :class:`perfbench.check.Readings`.
    ``fault``: ``half_batch`` takes each loss over the first half of each
    rank's rows."""
    params = dict(initial_state(config, seed, device))
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
            tok, tgt = batch["tokens"], batch["targets"]
            if fault == "half_batch":
                tok, tgt = tok[:len(tok) // 2], tgt[:len(tgt) // 2]
            loss = ref.loss(params, tok, tgt, config, prec)
            g = torch.autograd.grad(loss / world, [params[n] for n in names])
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            step_losses.append(float(loss.detach()))
            del loss, g
        losses.append(step_losses[0] if loss_over == "rank"
                      else sum(step_losses) / world)
        norms = leaf_norms(zip(names, grads), split)
        grad = grad or norms
        grad_max = {k: max(v, grad_max.get(k, 0.0)) for k, v in norms.items()}
        opt.step(list(grads))
        del grads
    change = change_norms(params.items(), initial_state(config, seed, device),
                          split)
    return Readings(losses, grad, change, grad_max)
