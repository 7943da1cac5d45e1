"""Tensors the eager runtime executed over the responses that carried
them, over the window (the registry's ``eager_tensors_executed_total`` and
``eager_responses_executed_total``): how many hooks one fused collective
served."""


def read(ctx):
    responses = ctx.counters.get("eager_responses_executed_total", 0)
    if not responses:
        return None
    return ctx.counters.get("eager_tensors_executed_total", 0) / responses
