"""Seconds from the process's start to the window's: the model made on
the device from the seed, the first steps (and their capture), warm-up."""


def read(ctx):
    return ctx.setup_s
