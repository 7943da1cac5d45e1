"""Self-tuning serving: the port of ``horovod_tpu/tuning/``, with the
same exports.

* :mod:`~horovod_tpu_torch.tuning.gp` — the Gaussian process,
  Expected Improvement and the categorical sweep, in NumPy;
* :mod:`~horovod_tpu_torch.tuning.params` — the online knob space, each
  value of which replays a CUDA graph warmup captured;
* :mod:`~horovod_tpu_torch.tuning.tuner` — the online tuner driven from
  the engine's step (``EngineConfig.autotune``);
* :mod:`~horovod_tpu_torch.tuning.replay` — rebuild a journaled trace and
  re-drive an engine with it: the offline tuning backend
  (``python -m horovod_tpu_torch.tuning.replay``).
"""

from horovod_tpu_torch.tuning.gp import (
    BayesianOptimizer,
    CategoricalSweep,
    ExpectedImprovement,
    GaussianProcess,
)
from horovod_tpu_torch.tuning.params import (
    Knob,
    KnobSpace,
    apply_settings,
    online_knob_space,
)
from horovod_tpu_torch.tuning.tuner import (
    Objective,
    OnlineTuner,
    WindowStats,
)
from horovod_tpu_torch.tuning.replay import (
    ReplayReport,
    TraceRequest,
    read_trace,
    replay,
)

__all__ = [
    "GaussianProcess", "ExpectedImprovement", "BayesianOptimizer",
    "CategoricalSweep",
    "Knob", "KnobSpace", "online_knob_space", "apply_settings",
    "Objective", "OnlineTuner", "WindowStats",
    "TraceRequest", "ReplayReport", "read_trace", "replay",
]
