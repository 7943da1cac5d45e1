"""horovod_tpu_torch: the PyTorch + CUDA port of ``horovod_tpu``.

A second package beside the JAX one, built slice by slice; the JAX
package stays the reference each slice is tested against.  This slice
serves the flagship Transformer LM: ``models`` (parameters, prefill,
paged decode), ``ops`` (the hand-written Hopper kernels — flash
attention forward and paged-attention decode — each beside its plain
PyTorch version), ``serving`` (the paged greedy continuous-batching
engine and its HTTP server) and ``obs`` (the metrics registry).

It imports ``torch`` and never ``jax`` or ``horovod_tpu``.  Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""
