"""K2 and K3 together, the flash-attention backward: the least time the
card could take for one backward at the cell's shapes
(``perfbench.arith.attention_bwd``) over the two kernels' mean device time
a call in the traced stretch, in %."""

from perfbench import arith

DKDV, DQ = r"\bflash_bwd_dkdv_kernel", r"\bflash_bwd_dq_kernel"


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    t2, n2 = ctx.trace.seconds_matching(DKDV)
    t3, n3 = ctx.trace.seconds_matching(DQ)
    if not n2 or n2 != n3:
        return None
    d = arith.lm_dims(ctx.config)
    flops, nbytes = arith.attention_bwd(ctx.traffic["batch"], d["H"],
                                        d["Hkv"], ctx.traffic["seq"], d["Dh"])
    return 100.0 * arith.bound_seconds(flops, nbytes, ctx.peak) / (
        (t2 + t3) / n2)
