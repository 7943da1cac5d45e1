"""``spmd.make_train_step`` over ``optim.DistributedOptimizer``: two eager
warm-up steps, then one CUDA graph a step, as ``horovod_tpu_torch.bench``
runs it.  Its loss is averaged over the ranks."""

LOSS_OVER = "world"


def make(target, inner, loss_fn, named, spans):
    from horovod_tpu_torch import optim, spmd

    opt = optim.DistributedOptimizer(inner, named_parameters=named)
    train = spmd.make_train_step(loss_fn, opt)
    return opt, lambda b: train(target, b)
