"""The table of peaks, and what a run reports of its card.

Published dense rates of one card, by the start of
``torch.cuda.get_device_name``: NVIDIA's H100 SXM data sheet (the 80GB HBM3
part, at its 700 W limit), 989 TFLOP/s in bf16 without sparsity and 3.35
TB/s of HBM.  A card missing from the table has no peak, and every share
of a peak then reads nothing (never 0).
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peak_of(kind: str) -> Optional[Dict[str, float]]:
    return next((v for k, v in PEAKS.items() if kind.startswith(k)), None)


def power_limit_w(index: int = 0) -> Optional[float]:
    """The card's power limit in watts as ``nvidia-smi`` reports it, or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
