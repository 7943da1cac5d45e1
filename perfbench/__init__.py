"""The benchmark of ``horovod_tpu_torch`` on the card: ``BENCHMARK.json``'s
cells, run one at a time by ``python3 -m perfbench.run`` (see there).

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or ``horovod_tpu``; the
plain references under ``reference/`` import nothing of the program.
"""
