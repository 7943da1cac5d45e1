"""Share of the traced stretch's device-busy time spent in BatchNorm's
kernels (PyTorch's native ``batch_norm_*`` kernels and cuDNN's ``bn_*``),
in %."""

PATTERN = r"(?i)batch_?norm|\bbn_(fw|bw)"


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    t, n = ctx.trace.seconds_matching(PATTERN)
    return 100.0 * t / ctx.trace.busy_s if n else None
