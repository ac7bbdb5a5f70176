"""Roofline-driven PUL planner (beyond-paper contribution).

The paper *sweeps* preload distance and transfer size experimentally (Exps.
3-4) and reports where the plateaus are. This module derives those settings
analytically from the same queueing model, so kernels self-configure:

Steady-state of a distance-d pipeline over blocks with per-block compute time
``T_c`` (PE) and per-request I/O time ``T_io = latency + bytes/bandwidth``
(serial DMA channel):

  * throughput-bound floor: a block cannot be consumed faster than
    ``max(T_c, bytes/bandwidth)`` — the roofline;
  * latency is hidden once the window covers it: ``d * T_c >= T_io``, i.e.
    ``d* = ceil(T_io / T_c)`` — the paper's observed plateau (d≈16 for its
    NVM latencies and SUM compute) falls out of this directly;
  * distances beyond d* only cost scratchpad space: diminishing returns,
    exactly Fig. 5-A.

The reference's transfer-size chooser (`choose_block_rows`) budgets a ring
against TPU VMEM; the port's kernels budget their rings against Hopper's
shared memory instead (`kernels.pul_attention.ring_plan`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from repro_torch.core.pul import (
    IssueStrategy,
    MemoryTier,
    PEModel,
    PULConfig,
)


@dataclasses.dataclass(frozen=True)
class Plan:
    cfg: PULConfig
    t_compute_per_block: float
    t_io_per_block: float
    predicted_time_per_block: float
    bound: str                      # "compute" | "bandwidth" | "latency"

    @property
    def predicted_utilization(self) -> float:
        return self.t_compute_per_block / self.predicted_time_per_block


def optimal_distance(t_compute: float, t_io: float, *, fifo_depth: int = 64) -> int:
    """d* = ceil(T_io / T_c): smallest window that hides the I/O time."""
    if t_compute <= 0:
        return fifo_depth
    return max(1, min(fifo_depth, math.ceil(t_io / t_compute)))


def plan_stream(
    *,
    block_bytes: int,
    flops_per_block: float,
    tier: MemoryTier,
    pe: PEModel,
    fifo_depth: int = 64,
    strategy: IssueStrategy = IssueStrategy.BATCH,
    block_shape: Optional[Tuple[int, ...]] = None,
) -> Plan:
    """Pick (distance, slots) for one preload stream and predict its rate."""
    t_c = pe.compute_time(flops_per_block)
    t_bw = block_bytes / tier.bandwidth
    t_io = tier.read_latency + t_bw
    d = optimal_distance(t_c, t_io, fifo_depth=fifo_depth)
    per_block = max(t_c, t_bw, t_io / max(d, 1))
    if per_block == t_c:
        bound = "compute"
    elif per_block == t_bw:
        bound = "bandwidth"
    else:
        bound = "latency"
    cfg = PULConfig(
        distance=d,
        strategy=strategy,
        fifo_depth=fifo_depth,
        **({"block_shape": block_shape} if block_shape else {}),
    )
    return Plan(cfg, t_c, t_io, per_block, bound)


def kv_page_bytes(page_tokens: int, kv_features: int, itemsize: int = 2) -> int:
    """Bytes of one KV page: `page_tokens` tokens x `kv_features` packed
    per-token KV features (every attention layer's K and V concatenated —
    the paged engine's page layout) x bf16 by default."""
    return page_tokens * kv_features * itemsize


def kv_page_flops(page_tokens: int, kv_features: int, gqa_group: int = 1) -> float:
    """Decode-attention compute consuming one KV page in one step.

    Per query head group the scores (q . k^T) and the weighted sum (p . v)
    each do ~2 MACs per cached feature; all `gqa_group` query heads of a KV
    group ride the same page transfer (PUL's amortized transfer size), so
    compute scales with the group while bytes don't."""
    return 4.0 * page_tokens * kv_features * gqa_group


def plan_kv_page_stream(
    *,
    page_tokens: int,
    kv_features: int,
    tier: MemoryTier,
    pe: PEModel,
    gqa_group: int = 1,
    itemsize: int = 2,
    fifo_depth: int = 64,
    strategy: IssueStrategy = IssueStrategy.BATCH,
) -> Plan:
    """Plan the page-restore preload stream of the paged-KV serving engine.

    The unit block is one KV page; d* = ceil(T_io / T_c) is the number of
    pages the engine requests ahead of the attention step consuming them —
    the paper's preload distance applied to KV paging."""
    return plan_stream(
        block_bytes=kv_page_bytes(page_tokens, kv_features, itemsize),
        flops_per_block=kv_page_flops(page_tokens, kv_features, gqa_group),
        tier=tier,
        pe=pe,
        fifo_depth=fifo_depth,
        strategy=strategy,
    )


def roofline_time(flops: float, bytes_moved: float, tier: MemoryTier, pe: PEModel) -> float:
    """Ideal (perfectly overlapped) execution time — the roofline itself."""
    return max(pe.compute_time(flops), bytes_moved / tier.bandwidth)


def predicted_speedup(
    *,
    block_bytes: int,
    flops_per_block: float,
    tier: MemoryTier,
    pe: PEModel,
) -> float:
    """Interleaved vs phase-separated execution — the paper's Fig. 1 claim.

    Baseline (no PUL): every block pays T_io + T_c serially.
    PUL at d*: per-block cost max(T_c, T_bw).
    """
    t_c = pe.compute_time(flops_per_block)
    t_io = tier.read_latency + block_bytes / tier.bandwidth
    base = t_c + t_io
    pul = max(t_c, block_bytes / tier.bandwidth)
    return base / pul if pul > 0 else float("inf")
