"""Share of the traced stretch (CUDA events around it) in which no kernel,
copy or fill ran on the card (the union of the profiler's device
intervals), in %."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share()
