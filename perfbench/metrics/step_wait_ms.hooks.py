"""Mean ms a window step spent in the hook optimizer's ``step()``: waiting
on the hooks' allreduce handles, then the update (the benchmark's span
around the call, host clock)."""


def read(ctx):
    span = ctx.spans.get("optimizer_step")
    if not span or not span[1]:
        return None
    return span[0] / span[1] * 1e3
