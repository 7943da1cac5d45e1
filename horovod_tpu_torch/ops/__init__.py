"""Kernels and their plain PyTorch versions.

* :mod:`.attention` — flash attention: forward (kernel K1,
  ``csrc/flash_fwd.cu``) and backward (K2 and K3, ``csrc/flash_bwd.cu``)
  beside ``_reference_attention_lse`` and ``_flash_bwd_reference``.
* :mod:`.paged_attention` — paged-attention decode (kernel K4,
  ``csrc/paged_attention.cu``) and ``paged_attend_reference``.
* :mod:`.grouped_matmul` — the grouped (ragged) product of the dropless
  MoE dispatch (kernel G1, ``csrc/grouped_matmul.cu``, the counterpart
  of ``lax.ragged_dot``) and ``grouped_matmul_reference``.
* :mod:`.moe` — mixture-of-experts dispatch: ``switch_moe`` (sort or
  cumsum, expert parallelism over a process group) and
  ``dropless_moe`` (G1).
* :mod:`._cuda` — the ``nvcc`` build and ``ctypes`` binding they share.
* :mod:`.collectives`, :mod:`.adasum`, :mod:`.sparse`, :mod:`.fusion`,
  :mod:`.compression` — the gradient reduction of the data-parallel step
  over ``torch.distributed``.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches its kernel or raises.
"""

from horovod_tpu_torch.ops.attention import (  # noqa: F401
    expand_kv,
    flash_attention,
    flash_attention_shifted,
    flash_attention_with_lse,
    reference_attention,
)
from horovod_tpu_torch.ops.paged_attention import (  # noqa: F401
    DEQUANT_COMPUTE,
    paged_attend,
    paged_attend_reference,
)
