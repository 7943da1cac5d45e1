"""The 95th percentile of every step of the window, each step the interval
on the card's timeline between CUDA events recorded at its boundaries."""


def read(ctx):
    return ctx.window.step_ms_p95()
