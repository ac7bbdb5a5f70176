"""Paged serving of the port: page pool, scheduler, engine, config."""
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import (
    EngineMetrics,
    PagedEngineConfig,
    PagedServingEngine,
    mean,
)
from repro_torch.serving.kv_pages import (
    KV_LAYOUT_VERSION,
    KVPagePool,
    PackedKVLayout,
    PageConfig,
    PoolMetrics,
)
from repro_torch.serving.scheduler import (
    POLICIES,
    AdmissionScheduler,
    Request,
    SchedulerConfig,
)

__all__ = [
    "ServingConfig", "Request",
    "PagedEngineConfig", "PagedServingEngine", "EngineMetrics",
    "KVPagePool", "KV_LAYOUT_VERSION", "PackedKVLayout", "PageConfig",
    "PoolMetrics", "AdmissionScheduler", "SchedulerConfig", "POLICIES",
    "mean",
]
