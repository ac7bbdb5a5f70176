"""PUL core of the port: the paper's knobs, the planner and the DMA twin.

Copies of the reference package's pure-Python core (`core/pul.py`,
`core/planner.py`, `core/dma.py`) with the TPU constants replaced by H100
tiers. The ring substrate (`core/pipeline.py` in the reference) has no module
here: on Hopper the ring lives inside each CUDA kernel (`csrc/`).
"""
from repro_torch.core.pul import (
    CP_ASYNC_BYTES,
    DRAM,
    H100_HBM,
    H100_PINNED_HOST,
    H100_SM,
    MICROBLAZE,
    NVM,
    PES,
    TIERS,
    UPMEM_DPU,
    Direction,
    IssueStrategy,
    MemoryTier,
    PEModel,
    PULConfig,
    TransferRequest,
)
from repro_torch.core.dma import (
    DMAEngine,
    KVPageWorkload,
    StreamStats,
    kv_page_latency_hidden,
    run_kv_page_workload,
    speedup,
)
from repro_torch.core.planner import (
    Plan,
    kv_page_bytes,
    kv_page_flops,
    optimal_distance,
    plan_kv_page_stream,
    plan_stream,
    predicted_speedup,
    roofline_time,
)

__all__ = [
    "PULConfig", "IssueStrategy", "Direction", "MemoryTier", "PEModel",
    "TransferRequest", "DRAM", "NVM", "H100_HBM", "H100_PINNED_HOST", "TIERS",
    "PES", "MICROBLAZE", "UPMEM_DPU", "H100_SM", "CP_ASYNC_BYTES",
    "DMAEngine", "StreamStats", "speedup",
    "KVPageWorkload", "run_kv_page_workload", "kv_page_latency_hidden",
    "Plan", "plan_stream", "optimal_distance", "predicted_speedup",
    "roofline_time", "plan_kv_page_stream", "kv_page_bytes", "kv_page_flops",
]
