"""PUL configuration and request descriptors.

This module defines the *software contract* of the paper's technique:

- :class:`PULConfig` — the tunable knobs the paper exposes (preload distance,
  transfer/block size, issue strategy, unload distance) plus the ring's slot
  count (shared-memory slots on the GPU).
- :class:`TransferRequest` — one entry of the DMA engine's FIFO, mirroring the
  paper's HW-register interface (src addr, dst addr, size), used by the
  discrete-event model (`core.dma`) and the page pool's descriptors.

The paper distinguishes *pre-loading* (slow memory -> scratchpad, ahead of
consumption) from *un-loading* (scratchpad -> slow memory, behind production).
Both directions share the descriptor type; direction is explicit.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence, Tuple


class IssueStrategy(str, enum.Enum):
    """Issue orderings studied in the paper's Experiment 3 (Fig. 5-D).

    BATCH:      issue the full warm-up window of `distance` requests first,
                then enter the steady state (paper: "batch-wise execution").
    SEQUENTIAL: alternate one issue / one compute from the start
                (paper: "sequential interleaving").
    The paper finds BATCH >= SEQUENTIAL for I/O throughput below the latency
    plateau, converging above it; BATCH is therefore the default.
    """

    BATCH = "batch"
    SEQUENTIAL = "sequential"


class Direction(str, enum.Enum):
    PRELOAD = "preload"  # slow memory -> scratchpad
    UNLOAD = "unload"    # scratchpad  -> slow memory


# Hopper's asynchronous copy granule: cp.async moves 16 bytes per thread, so
# a streamed block (a KV page slab) must be a multiple of 16 bytes.
CP_ASYNC_BYTES = 16


@dataclasses.dataclass(frozen=True)
class PULConfig:
    """Knobs of the PUL engine (paper §2, Listing 1).

    Attributes:
      distance: preload distance `d` — number of blocks requested ahead of
        consumption. The paper's Exp. 3 plateaus at d≈16 for its latencies;
        on the GPU the planner (`core.planner`) derives d from block latency vs
        per-block compute time.
      unload_distance: how many blocks behind production the unload wait
        trails (0 = synchronous flush, the paper's non-PUL baseline).
      block_shape: scratchpad-block shape (the paper's configurable transfer
        size, Exp. 4). Product * dtype.itemsize = bytes per request.
      strategy: issue ordering (Exp. 3, Fig 5-D).
      slots: number of scratchpad buffers. Defaults to 2*distance for BATCH
        (double-buffered batches: the next batch lands while the previous is
        consumed) and distance+1 for SEQUENTIAL (issue of block i+d starts
        before block i's slot is free).
      fifo_depth: capacity of the modeled DMA request queue (the paper's HW
        FIFO holds 64 requests); the emitter asserts distance <= fifo_depth.
    """

    distance: int = 4
    unload_distance: int = 1
    block_shape: Tuple[int, ...] = (16, 128)   # one (page_tokens, head_dim) slab
    strategy: IssueStrategy = IssueStrategy.BATCH
    slots: Optional[int] = None
    fifo_depth: int = 64

    def __post_init__(self):
        if self.distance < 1:
            raise ValueError(f"preload distance must be >= 1, got {self.distance}")
        if self.distance > self.fifo_depth:
            raise ValueError(
                f"distance {self.distance} exceeds DMA FIFO depth {self.fifo_depth} "
                "(the paper's engine queues at most fifo_depth outstanding requests)"
            )
        if self.unload_distance < 0:
            raise ValueError("unload distance must be >= 0")
        if self.slots is not None and self.slots < self.distance:
            raise ValueError(
                f"slots ({self.slots}) must be >= distance ({self.distance}): "
                "a block must stay resident until it is consumed"
            )

    @property
    def num_slots(self) -> int:
        if self.slots is not None:
            return self.slots
        if self.strategy is IssueStrategy.BATCH:
            return 2 * self.distance
        return self.distance + 1

    def transfer_bytes(self, itemsize: int) -> int:
        return int(math.prod(self.block_shape)) * itemsize

    def replace(self, **kw) -> "PULConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TransferRequest:
    """One FIFO entry of the (modeled) DMA engine.

    Mirrors the paper's register interface: physical src, dst, size. `issue_t`
    is filled in by the discrete-event model; `tag` identifies the logical
    block for the pipeline emitter.
    """

    direction: Direction
    src: int              # abstract address (block index * block bytes)
    dst: int
    nbytes: int
    tag: int = -1
    issue_t: float = 0.0


@dataclasses.dataclass(frozen=True)
class MemoryTier:
    """Latency/bandwidth model of one memory technology (paper Fig. 2).

    Values are per-request latency (seconds) and sustained bandwidth
    (bytes/second). Defaults below are the tiers used across benchmarks.
    """

    name: str
    read_latency: float
    write_latency: float
    bandwidth: float

    def transfer_time(self, nbytes: int, direction: Direction) -> float:
        lat = self.read_latency if direction is Direction.PRELOAD else self.write_latency
        return lat + nbytes / self.bandwidth


# Paper tiers (NDP experiments; §3 Experimental Setup): DRAM vs emulated NVM
# (350 ns read / 170 ns write), system bandwidth capped at 8 GiB/s.
DRAM = MemoryTier("dram", read_latency=100e-9, write_latency=100e-9, bandwidth=8 * 2**30)
NVM = MemoryTier("nvm", read_latency=350e-9, write_latency=170e-9, bandwidth=8 * 2**30)
# H100 tiers of the port, measured by `chip_smoke.py` (phase "device") on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit, with CUDA events around
# copies enqueued behind a busy card (device time, no launch overhead):
#   fast tier: device HBM -- a 1 GiB device-to-device copy ran at 1501.6 GB/s
#     of copy size (3003 GB/s read + write); one 4 KiB copy took 5.12 us;
#   slow tier: pinned host memory over PCIe, where the port's cold tier lives
#     -- a 256 MiB pinned host-to-device copy ran at 52.06 GB/s; one 4 KiB
#     copy took 9.89 us.
H100_HBM = MemoryTier("h100_hbm", read_latency=5.12e-6, write_latency=5.12e-6,
                      bandwidth=1501.6e9)
H100_PINNED_HOST = MemoryTier("h100_pinned_host", read_latency=9.89e-6,
                              write_latency=9.89e-6, bandwidth=52.06e9)

TIERS = {t.name: t for t in (DRAM, NVM, H100_HBM, H100_PINNED_HOST)}


@dataclasses.dataclass(frozen=True)
class PEModel:
    """Compute model of the weak PE (paper: 150 MHz MicroBlaze / 350 MHz DPU).

    `flops_per_cycle` captures scalar in-order issue (1 for the paper's PEs).
    For the GPU the planner uses one SM's fp32 rate (`H100_SM`); this
    class exists so the DMA simulator can replay the paper's numbers
    faithfully.
    """

    name: str
    clock_hz: float
    flops_per_cycle: float = 1.0

    def compute_time(self, flops: float) -> float:
        return flops / (self.clock_hz * self.flops_per_cycle)


MICROBLAZE = PEModel("microblaze", 150e6)           # NDP soft-core
UPMEM_DPU = PEModel("upmem_dpu", 350e6)             # PIM
# One H100 SM running the paged-decode kernel's fp32 math: 128 FP32 lanes x
# 2 flops (FMA) per cycle at the card's maximum SM clock, 1980 MHz as
# nvidia-smi reads it (`chip_smoke.py`, phase "device"; NVIDIA H100 80GB
# HBM3, 700 W power limit).
H100_SM = PEModel("h100_sm", 1.98e9, flops_per_cycle=256)

PES = {p.name: p for p in (MICROBLAZE, UPMEM_DPU, H100_SM)}
