"""Serving of the port: page pool, scheduler, engines, config."""
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import (
    EngineConfig,
    EngineMetrics,
    PagedEngineConfig,
    PagedServingEngine,
    ServingEngine,
    mean,
    percentile,
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
    "ServingConfig", "Request", "EngineConfig", "ServingEngine",
    "PagedEngineConfig", "PagedServingEngine", "EngineMetrics",
    "KVPagePool", "KV_LAYOUT_VERSION", "PackedKVLayout", "PageConfig",
    "PoolMetrics", "AdmissionScheduler", "SchedulerConfig", "POLICIES",
    "mean", "percentile",
]
