"""K1, the flash-attention forward: the least time the card could take
for one call at the cell's shapes (``perfbench.arith.attention_fwd``:
causal, grouped-query, bf16) over the kernel's mean device time a call in
the traced stretch, in %."""

from perfbench import arith

KERNEL = r"\bflash_fwd_kernel"


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    t, n = ctx.trace.seconds_matching(KERNEL)
    if not n:
        return None
    d = arith.lm_dims(ctx.config)
    flops, nbytes = arith.attention_fwd(ctx.traffic["batch"], d["H"],
                                        d["Hkv"], ctx.traffic["seq"], d["Dh"])
    return 100.0 * arith.bound_seconds(flops, nbytes, ctx.peak) / (t / n)
