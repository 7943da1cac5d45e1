"""The Transformer LM (training and serving), the vision models (ResNet,
InceptionV3) and the MLP, and the loaders for JAX weights."""

from horovod_tpu_torch.models import inception, mlp, resnet  # noqa: F401
from horovod_tpu_torch.models.convert import (  # noqa: F401
    params_from_jax,
    vision_from_flax,
)
from horovod_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    init_params,
)
