"""FLOPs, peak device memory and live MFU of a training step.

Counterpart of ``horovod_tpu/obs/xprof.py``.  The JAX package asks XLA
for a compiled program's cost; PyTorch has no compiled program to ask,
so :func:`introspect` runs one eager call under
``torch.utils.flop_counter.FlopCounterMode`` and reads
``torch.cuda.max_memory_allocated`` around it.

What the count covers: the counter counts matrix products, convolutions
and attention, forward and backward (each as ``2 · multiply-adds``).
XLA's ``cost_analysis`` also counts BatchNorm, the elementwise work and
the optimizer.  So the port's figure is the model's FLOPs (ResNet-50 at
224: about 3 × 8.2 GFLOP an image), not XLA's, and the bench names it
``flops_per_img``.

* :data:`PEAK_FLOPS_BY_KIND` / :func:`chip_peak_flops`: the dense bf16
  peak by ``torch.cuda.get_device_name``; None for a card not in the
  table and for the CPU, so that MFU fields become JSON null, never NaN.
* :func:`set_training_cost` + :func:`observe_step`: tell the registry a
  step's FLOPs once, and every ``obs.training_step()`` sets the live
  ``training_mfu`` gauge from the step's wall time.
* :func:`transformer_flops_per_token`: the analytic decode cost, 2 FLOPs
  a matmul parameter a token.

Metrics never gate the workload: a field that cannot be read is None.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional

import torch

from horovod_tpu_torch.obs.registry import default_registry, training_metrics

__all__ = [
    "CostReport", "introspect", "PEAK_FLOPS_BY_KIND", "chip_peak_flops",
    "mfu", "set_training_cost", "training_cost", "observe_step",
    "matmul_param_count", "transformer_flops_per_token",
]

# Dense bf16 FLOP/s a card by the start of torch.cuda.get_device_name.
# NVIDIA's H100 SXM data sheet (the 80GB HBM3 part, at its 700 W limit).
PEAK_FLOPS_BY_KIND: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def chip_peak_flops(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of ``device`` (default: the current CUDA
    device), or None for the CPU and for a card not in the table."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name(device)
    return next((v for k, v in PEAK_FLOPS_BY_KIND.items()
                 if kind.startswith(k)), None)


@dataclasses.dataclass
class CostReport:
    """One call of a step: ``flops`` counted by ``FlopCounterMode``
    (matrix products, convolutions and attention, forward and backward)
    and ``peak_mem_bytes``, the device's peak allocation during the call
    (None on the CPU)."""

    fn: str
    flops: Optional[float] = None
    peak_mem_bytes: Optional[float] = None


def introspect(step: Callable, *args, fn: str = "step", device=None):
    """Call ``step(*args)`` once, eagerly, counting its FLOPs and the
    device's peak memory during it -> ``(the step's result,
    CostReport)``.  The call is a real one (a train step updates its
    parameters): count a warm-up step.

    ``device`` (default: CUDA when it is available) is where the peak
    memory is read.  The report also sets the ``flops{fn=}`` and
    ``peak_memory_bytes{fn=}`` gauges of the default registry."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with FlopCounterMode(display=False) as counter:
        out = step(*args)
    peak = None
    if cuda:
        torch.cuda.synchronize(dev)
        peak = float(torch.cuda.max_memory_allocated(dev))
    report = CostReport(fn=fn, flops=float(counter.get_total_flops()),
                        peak_mem_bytes=peak)
    r = default_registry()
    r.gauge("flops", "FLOPs a call of an instrumented step "
            "(FlopCounterMode: matrix products, convolutions and "
            "attention, forward and backward)", labels=("fn",),
            exist_ok=True).labels(fn=fn).set(report.flops)
    if peak is not None:
        r.gauge("peak_memory_bytes", "Peak device bytes allocated during "
                "a call of an instrumented step", labels=("fn",),
                exist_ok=True).labels(fn=fn).set(peak)
    return out, report


def mfu(flops_per_step: Optional[float], step_seconds: float,
        peak: Optional[float] = None) -> Optional[float]:
    """Model-FLOPs utilization: ``flops / seconds / peak``.  None when the
    FLOPs or the peak are unknown, or the step time is not positive."""
    if peak is None:
        peak = chip_peak_flops()
    if not flops_per_step or not peak or step_seconds <= 0:
        return None
    return flops_per_step / step_seconds / peak


# -- live training MFU --------------------------------------------------------

_training_cost = (None, None)  # (flops_per_step, peak_flops)
_training_lock = threading.Lock()


def set_training_cost(flops_per_step: Optional[float],
                      peak: Optional[float] = None) -> None:
    """Arm the live ``training_mfu`` gauge: a step's FLOPs (from
    :func:`introspect` or an analytic count) and the card's peak
    (default :func:`chip_peak_flops`).  None disarms it."""
    global _training_cost
    if flops_per_step is None:
        with _training_lock:
            _training_cost = (None, None)
        return
    if peak is None:
        peak = chip_peak_flops()
    with _training_lock:
        _training_cost = (float(flops_per_step),
                          float(peak) if peak else None)


def training_cost():
    """The armed ``(flops_per_step, peak_flops)``; (None, None) when
    disarmed."""
    return _training_cost


def observe_step(step_seconds: float, mfu_gauge=None) -> Optional[float]:
    """A training step took ``step_seconds``: set the ``training_mfu``
    gauge when armed, and return the MFU (or None)."""
    flops, peak = _training_cost
    if flops is None or peak is None or step_seconds <= 0:
        return None
    u = flops / step_seconds / peak
    (mfu_gauge if mfu_gauge is not None else training_metrics().mfu).set(u)
    return u


def matmul_param_count(params) -> int:
    """Parameters taking part in matrix products: every tensor of the
    (nested dict) parameter tree but the ``embed`` table (a lookup)."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return tree.numel() if torch.is_tensor(tree) else 0

    total = count(params)
    if isinstance(params, dict) and torch.is_tensor(params.get("embed")):
        total -= params["embed"].numel()
    return total


def transformer_flops_per_token(params) -> float:
    """Analytic decode FLOPs a generated token: 2 a matmul parameter
    (forward only, the PaLM appendix-B convention; the attention-score
    term is left out)."""
    return 2.0 * matmul_param_count(params)
