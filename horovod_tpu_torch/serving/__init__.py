"""Continuous-batching serving: the paged greedy engine and its server."""

from horovod_tpu_torch.serving.cache import (  # noqa: F401
    NULL_PAGE,
    PagedSlotCache,
    init_page_pool,
    paged_insert,
    resolve_kv_dtype,
)
from horovod_tpu_torch.serving.engine import (  # noqa: F401
    DRAINING,
    FAILED,
    HEALTHY,
    EngineConfig,
    GenerationFuture,
    InferenceEngine,
)
from horovod_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from horovod_tpu_torch.serving.scheduler import (  # noqa: F401
    CacheOutOfPagesError,
    DeadlineExceededError,
    DrainingError,
    EngineFailedError,
    QueueFullError,
    Request,
    RequestTooLongError,
    Scheduler,
    ServingError,
)
from horovod_tpu_torch.serving.server import ServingServer  # noqa: F401
