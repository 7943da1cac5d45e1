"""State consistency: broadcast parameters, optimizer state and Python
objects, and gather objects.

Counterpart of ``horovod_tpu/state.py``: rank 0 restores (or
initializes), then broadcasts, so every rank starts identical.  Objects
travel pickled, as a uint8 tensor on the rank's device (the collectives'
backend moves device tensors): first the length, then the payload.
Unpickle only what the job's own ranks sent.
"""

from __future__ import annotations

import pickle
from typing import Any, List

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collectives as C

__all__ = ["allgather_object", "broadcast_object",
           "broadcast_optimizer_state", "broadcast_parameters",
           "named_parameters"]


def named_parameters(tree, prefix: str = "") -> List:
    """``(dotted name, tensor)`` for every tensor of a nested dict, in
    insertion order (``{"layers": {"wq": t}}`` -> ``[("layers.wq", t)]``)."""
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(named_parameters(v, name + "."))
        else:
            out.append((name, v))
    return out


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Overwrite every tensor of ``params`` — a nested dict of tensors,
    or pairs ``(name, tensor)`` — with ``root_rank``'s, in place."""
    items = (named_parameters(params) if isinstance(params, dict)
             else list(params))
    with torch.no_grad():
        for _, t in items:
            C.broadcast_(t, root_rank)


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Load ``root_rank``'s optimizer state (moments, step counts, group
    hyperparameters) into every rank's ``optimizer``.  The state dict
    travels as one object, so a rank without state yet (no step taken)
    gets it all the same."""
    basics.size()
    state = _to_cpu(optimizer.state_dict()) \
        if basics.rank() == root_rank else None
    optimizer.load_state_dict(broadcast_object(state, root_rank))


def _payload(obj) -> torch.Tensor:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(
        basics.device())


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    """``root_rank``'s ``obj`` on every rank: its pickled length, then the
    payload, each one broadcast (at size 1 too: the object comes back
    unpickled, a copy)."""
    mine = basics.rank() == root_rank
    payload = _payload(obj) if mine else None
    length = torch.tensor([payload.numel() if mine else 0],
                          dtype=torch.int64, device=basics.device())
    C.broadcast_(length, root_rank)
    if not mine:
        payload = torch.empty(int(length), dtype=torch.uint8,
                              device=basics.device())
    C.broadcast_(payload, root_rank)
    return pickle.loads(payload.cpu().numpy().tobytes())


def allgather_object(obj: Any) -> list:
    """Every rank's ``obj``, in rank order, on every rank."""
    payload = _payload(obj)
    lengths = C.allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                       device=payload.device)).tolist()
    data = C.allgather(payload).cpu().numpy().tobytes()
    out, off = [], 0
    for n in lengths:
        out.append(pickle.loads(data[off:off + n]))
        off += n
    return out
