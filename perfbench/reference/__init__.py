"""Plain float32 PyTorch references of the benchmark's models and
optimizers.  They import nothing of ``horovod_tpu_torch`` and use no kernel
of it: only ``torch``."""
