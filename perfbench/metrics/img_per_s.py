"""Images of every step of the window over the whole window, on the host's
clock (one chip)."""


def read(ctx):
    return ctx.window.rate("img")
