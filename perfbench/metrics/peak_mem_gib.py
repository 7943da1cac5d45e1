"""``torch.cuda.max_memory_allocated()`` from the process's start (set-up,
warm-up and capture included) to the window's end, in GiB."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2 ** 30
