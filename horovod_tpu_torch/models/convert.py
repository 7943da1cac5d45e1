"""Load the JAX package's parameters into the port: the Transformer LM's
(:func:`params_from_jax`) and the flax vision models' variables
(:func:`vision_from_flax`)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from horovod_tpu_torch.models.transformer import (
    _MATRICES,
    TransformerConfig,
    resolve_device,
)
from horovod_tpu_torch.models.vision_layers import BatchNorm, Conv

__all__ = ["params_from_jax", "vision_from_flax"]


def params_from_jax(tree: Dict, cfg: TransformerConfig, *,
                    device=None, param_dtype: torch.dtype = None) -> Dict:
    """The JAX package's parameter tree (``horovod_tpu.models.
    transformer.init_params`` layout, leaves as numpy arrays — or
    anything ``np.asarray`` takes) -> the port's dict of tensors, same
    names and shapes.

    Matrices are held in ``param_dtype``, by default ``cfg.dtype``: the
    serving load casts once here, and the model's casts at use are then
    no-ops, which gives JAX's values.  ``torch.float32`` keeps every leaf
    f32, as JAX does: the training load.  The RMSNorm scales stay f32,
    and so does an MoE model's ``router``: the switch and dropless
    dispatches route in f32 from the f32 parameter, as JAX's do, and a
    router rounded at load would route tokens differently."""
    device = resolve_device(device)
    param_dtype = param_dtype or cfg.dtype

    def load(x, cast: bool):
        t = torch.from_numpy(np.array(x, dtype=np.float32, copy=True))
        return t.to(device=device,
                    dtype=param_dtype if cast else torch.float32)

    moe = cfg.n_experts > 1
    expected = set(_MATRICES) | {"ln1", "ln2"} | ({"router"} if moe else set())
    layers = tree["layers"]
    if set(layers) != expected:
        raise ValueError(f"layer parameters {sorted(layers)} are not the "
                         f"{'MoE' if moe else 'dense'} model's "
                         f"{sorted(expected)}")
    return {
        "embed": load(tree["embed"], True),
        "layers": {k: load(v, k in _MATRICES) for k, v in layers.items()},
        "ln_f": load(tree["ln_f"], False),
        "head": load(tree["head"], True),
    }


def _flatten(tree, prefix=()) -> Dict[tuple, object]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# The port's leaf by module kind -> (flax collection, flax leaf name).
_LEAVES = {
    Conv: {"weight": ("params", "kernel")},
    nn.Linear: {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    BatchNorm: {"weight": ("params", "scale"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"),
                "running_var": ("batch_stats", "var")},
}


def _flax_layout(x: np.ndarray, kind) -> np.ndarray:
    """A flax leaf in the port's layout: conv kernels HWIO -> OIHW, Dense
    kernels ``(in, out)`` -> ``(out, in)``."""
    if kind is Conv and x.ndim == 4:
        return x.transpose(3, 2, 0, 1)
    if kind is nn.Linear and x.ndim == 2:
        return x.T
    return x


@torch.no_grad()
def vision_from_flax(variables: Dict, model: nn.Module, *,
                     device=None) -> nn.Module:
    """Load flax ``{"params", "batch_stats"}`` (the JAX package's ResNet or
    InceptionV3 variables, leaves as numpy arrays or anything
    ``np.asarray`` takes) into ``model``, a port model of the same
    architecture, moved to ``device`` (CUDA unless ``"cpu"`` is passed).
    Returns the model.

    Leaves are matched by path (the port's submodules carry flax's
    names): conv kernels HWIO -> OIHW, Dense ``(in, out)`` -> ``(out,
    in)``, BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, its
    ``mean``/``var`` -> the running buffers.  A tree with a missing or an
    extra leaf, or a leaf of another shape, raises ``ValueError``."""
    model.to(resolve_device(device))
    given = {(col,) + path: v for col in ("params", "batch_stats")
             for path, v in _flatten(variables.get(col, {})).items()}
    extra_cols = set(variables) - {"params", "batch_stats"}
    targets = {}
    for mod_name, mod in model.named_modules():
        leaves = _LEAVES.get(type(mod))
        if leaves is None:
            continue
        path = tuple(mod_name.split("."))
        for attr, (col, leaf) in leaves.items():
            targets[(col,) + path + (leaf,)] = (getattr(mod, attr), type(mod))
    missing = sorted("/".join(k) for k in set(targets) - set(given))
    extra = sorted("/".join(k) for k in set(given) - set(targets))
    if missing or extra or extra_cols:
        raise ValueError(f"the flax variables do not match the model: "
                         f"missing {missing[:8]}, extra "
                         f"{(extra + sorted(extra_cols))[:8]}")
    for key, (t, kind) in targets.items():
        x = _flax_layout(np.asarray(given[key], dtype=np.float32), kind)
        if tuple(x.shape) != tuple(t.shape):
            raise ValueError(f"{'/'.join(key)}: shape {tuple(x.shape)} is "
                             f"not the model's {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(x)))
    return model
