"""The window's model FLOPs (``perfbench.arith``'s count for the
configuration: convolutions and the classifier, forward and backward)
over its seconds and the card's bf16 peak, in %."""

from perfbench import arith


def read(ctx):
    rate = ctx.window.rate("img")
    if ctx.peak is None or rate is None:
        return None
    flops = arith.resnet_train_flops_per_image(ctx.config)
    return 100.0 * rate * flops / ctx.peak["bf16_flops"]
