"""Load the JAX package's Transformer parameters into the port."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from horovod_tpu_torch.models.transformer import (
    _MATRICES,
    TransformerConfig,
    resolve_device,
)

__all__ = ["params_from_jax"]


def params_from_jax(tree: Dict, cfg: TransformerConfig, *,
                    device=None) -> Dict:
    """The JAX package's parameter tree (``horovod_tpu.models.
    transformer.init_params`` layout, leaves as numpy arrays — or
    anything ``np.asarray`` takes) -> the port's dict of tensors, same
    names and shapes.

    JAX keeps f32 parameters and casts each matrix to ``cfg.dtype`` at
    every use; the port casts once here, which gives the same values.
    The RMSNorm scales stay f32, as JAX uses them."""
    device = resolve_device(device)

    def load(x, cast: bool):
        t = torch.from_numpy(np.array(x, dtype=np.float32, copy=True))
        return t.to(device=device, dtype=cfg.dtype if cast else torch.float32)

    expected = set(_MATRICES) | {"ln1", "ln2"}
    layers = tree["layers"]
    if set(layers) != expected:
        raise ValueError(f"layer parameters {sorted(layers)} are not the "
                         f"dense model's {sorted(expected)}")
    return {
        "embed": load(tree["embed"], True),
        "layers": {k: load(v, k in _MATRICES) for k, v in layers.items()},
        "ln_f": load(tree["ln_f"], False),
        "head": load(tree["head"], True),
    }
