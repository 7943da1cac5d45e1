"""Kernels and their plain PyTorch versions.

* :mod:`.attention` — flash-attention forward (kernel K1,
  ``csrc/flash_fwd.cu``) and ``_reference_attention_lse``.
* :mod:`.paged_attention` — paged-attention decode (kernel K4,
  ``csrc/paged_attention.cu``) and ``paged_attend_reference``.
* :mod:`._cuda` — the ``nvcc`` build and ``ctypes`` binding they share.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches its kernel or raises.
"""

from horovod_tpu_torch.ops.attention import (  # noqa: F401
    expand_kv,
    flash_attention,
    flash_attention_lse,
    reference_attention,
)
from horovod_tpu_torch.ops.paged_attention import (  # noqa: F401
    DEQUANT_COMPUTE,
    paged_attend,
    paged_attend_reference,
)
