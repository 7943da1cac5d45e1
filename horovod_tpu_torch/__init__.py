"""horovod_tpu_torch: the PyTorch + CUDA port of ``horovod_tpu``.

A second package beside the JAX one, built slice by slice; the JAX
package stays the reference each slice is tested against.  It serves
and trains the flagship Transformer LM: ``models`` (parameters, the
training forward and loss, prefill, paged decode), ``ops`` (the
hand-written Hopper kernels — flash attention forward and backward,
paged-attention decode — each beside its plain PyTorch version, and the
collectives, Adasum, sparse reduction, fusion and compression of the
gradient reduction),
``basics`` (process group, rank and size, the local and cross groups
over ``torch.distributed``), ``optim`` (``DistributedOptimizer``,
``DistributedAdasumOptimizer``, ``DistributedGradientTape``), ``state``
(parameter, optimizer-state and object broadcast), ``join`` (masked
averaging for ranks out of data), ``spmd`` (the data-parallel train
step, captured as a CUDA graph on the card), ``serving`` (the paged
continuous-batching engine and its HTTP server), ``obs`` (the metrics
registry, ``xprof``'s FLOP count and live MFU, ``training_step``),
``data`` (the rank-sharded, device-prefetching ``DataLoader``) and
``bench`` (the synthetic ResNet-50 img/s benchmark); ``models`` also
holds the vision models (ResNet, InceptionV3, the MLP) and their loader
for flax variables.

It imports ``torch`` and never ``jax`` or ``horovod_tpu``.  Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""
