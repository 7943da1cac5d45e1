"""The Transformer LM (serving path) and the loader for JAX weights."""

from horovod_tpu_torch.models.convert import params_from_jax  # noqa: F401
from horovod_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    init_params,
)
