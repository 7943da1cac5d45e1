"""Kernels and their plain PyTorch versions.

* :mod:`.attention` — flash attention: forward (kernel K1,
  ``csrc/flash_fwd.cu``) and backward (K2 and K3, ``csrc/flash_bwd.cu``)
  beside ``_reference_attention_lse`` and ``_flash_bwd_reference``.
* :mod:`.paged_attention` — paged-attention decode (kernel K4,
  ``csrc/paged_attention.cu``) and ``paged_attend_reference``.
* :mod:`._cuda` — the ``nvcc`` build and ``ctypes`` binding they share.
* :mod:`.collectives`, :mod:`.fusion`, :mod:`.compression` — the
  gradient reduction of the data-parallel step over ``torch.distributed``.

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
