"""Continuous-batching serving: the paged engine (per-slot sampling, the
overlapped decode pipeline, the tick as one CUDA graph; supervised
restarts with journaled resume, the watchdog, preemption and priority
classes; shared prefixes and chunked prefill), its slot-contiguous
baseline (``EngineConfig(paged=False)``) and its server."""

from horovod_tpu_torch.serving.cache import (  # noqa: F401
    NULL_PAGE,
    PagedSlotCache,
    SlotCache,
    init_page_pool,
    init_slot_cache,
    insert_prefill,
    insert_prefill_batch,
    paged_insert,
    resolve_kv_dtype,
)
from horovod_tpu_torch.serving.engine import (  # noqa: F401
    DEGRADED,
    DRAINING,
    FAILED,
    HEALTHY,
    EngineConfig,
    GenerationFuture,
    InferenceEngine,
)
from horovod_tpu_torch.serving.faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    InjectedFaultError,
)
from horovod_tpu_torch.serving.journal import (  # noqa: F401
    JournalEntry,
    RequestJournal,
)
from horovod_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from horovod_tpu_torch.serving.sampling import (  # noqa: F401
    MAX_SEED,
    SamplingParams,
    SlotSampling,
    seed_key,
)
from horovod_tpu_torch.serving.scheduler import (  # noqa: F401
    PRIORITY_CLASSES,
    CacheOutOfPagesError,
    DeadlineExceededError,
    DrainingError,
    EngineFailedError,
    EngineStalledError,
    QueueFullError,
    Request,
    RequestTooLongError,
    Scheduler,
    ServingError,
    priority_rank,
)
from horovod_tpu_torch.serving.sharding import (  # noqa: F401
    ServingSharding,
    ShardingConfigError,
)
from horovod_tpu_torch.serving.server import (  # noqa: F401
    TRACE_ID_HEADER,
    ServingServer,
)
