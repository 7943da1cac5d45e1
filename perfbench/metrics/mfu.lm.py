"""The window's model FLOPs (``perfbench.arith``: 6 a matrix parameter a
token plus causal attention) over its seconds and the card's bf16 peak,
in %."""

from perfbench import arith


def read(ctx):
    rate = ctx.window.rate("tokens")
    if ctx.peak is None or rate is None:
        return None
    flops = arith.lm_train_flops_per_token(ctx.config, ctx.traffic["seq"])
    return 100.0 * rate * flops / ctx.peak["bf16_flops"]
