"""The user's own loop (``zero_grad``, forward, ``backward``, ``step``)
through ``horovod_tpu_torch.torch.DistributedOptimizer``'s gradient hooks,
eager, as Horovod's ``pytorch_synthetic_benchmark.py`` writes it.  The
span around the optimizer's ``step()`` (waiting on the hooks' handles,
then the update) is kept as ``optimizer_step``."""

import time

LOSS_OVER = "rank"


def make(target, inner, loss_fn, named, spans):
    import horovod_tpu_torch.torch as hvd
    from torch.profiler import record_function

    opt = hvd.DistributedOptimizer(inner, named_parameters=named)
    span = spans.setdefault("optimizer_step", [0.0, 0])

    def step(b):
        opt.zero_grad()
        with record_function("bench.forward"):
            loss = loss_fn(target, b)
        with record_function("bench.backward"):
            loss.backward()
        t0 = time.perf_counter()
        with record_function("bench.optimizer_step"):
            opt.step()
        span[0] += time.perf_counter() - t0
        span[1] += 1
        return loss.detach()

    return opt, step
