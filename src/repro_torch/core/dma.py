"""Discrete-event model of the paper's custom DMA engine.

The paper (§2) builds a custom DMA engine on an Alveo U280: two 64-deep FIFO
queues (preload / unload), non-blocking enqueue via HW registers, completion
via a status register, attached to a 150 MHz MicroBlaze PE with 64 KiB BRAM
scratchpad. We cannot synthesize that on a GPU; instead this module is a
cycle-approximate *software twin* of the engine, used to

  1. reproduce the paper's Experiments 1, 3, 4, 5 (benchmarks/bench_exp*.py)
     with the paper's own latency constants (DRAM vs NVM via NVMulator), and
  2. calibrate `core.planner`, which picks preload distance / transfer size
     for the real kernels from the same queueing math.

Model fidelity (matches the paper's described HW):
  * each direction has ONE channel processing its FIFO in order. Outstanding
    requests *pipeline*: the wire (bandwidth) is the serial resource, while
    per-request access latency overlaps across queued requests — this
    memory-level parallelism is exactly why deeper preload distances help
    (paper Fig. 5) until the window covers the latency;
  * enqueue costs the PE `issue_cycles` (writing src/dst/size registers);
    *register-value buffering* (paper §2) makes repeat enqueues with an
    unchanged size cheaper (`issue_cycles_cached`);
  * the FIFO holds `fifo_depth` outstanding requests; enqueue to a full FIFO
    blocks the PE (the paper never hits this: practical distances < 16);
  * waiting polls the status register: time = max(0, completion - now).

Issue strategies (paper Exp. 3, Fig 5-D):
  * SEQUENTIAL — warm-up of d requests, then the steady state alternates
    `PL[i+d] -> compute[i]`;
  * BATCH — requests are fired in back-to-back batches of d, then the
    *previous* batch is consumed (keeps the serial DMA channel gap-free; the
    paper finds it >= sequential below the latency plateau).

Multi-PE scaling (Exp. 1/4) is modeled by the aggregate-bandwidth cap: K PEs
run the single-PE schedule independently until the sum of their streaming
demands saturates `tier.bandwidth` (the paper's system tops out at 8 GiB/s).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

from repro_torch.core.pul import (
    Direction,
    IssueStrategy,
    MemoryTier,
    PEModel,
    PULConfig,
)
from repro_torch.obs.tracer import NULL_TRACER


@dataclasses.dataclass
class _Channel:
    """One serial DMA channel with a FIFO queue.

    Instrumented for the invariant tests and the trace layer: `wire_log`
    records each request's (enqueue_time, wire_start, wire_end) interval —
    the wire is the serial resource, so intervals must never overlap;
    `occupancy_log` samples (time, outstanding) at every enqueue — the
    executed FIFO-occupancy track that `analysis.plan_verifier.
    diff_fifo_occupancy` diffs against the symbolic schedule;
    `max_outstanding` tracks the deepest the FIFO ever got (must stay <=
    fifo_depth) and `high_water_time` the model time it FIRST got there;
    `stalls` records (wanted, granted) back-pressure intervals where a full
    FIFO blocked the PE's enqueue.
    """

    tier: MemoryTier
    direction: Direction
    fifo_depth: int
    completions: List[float] = dataclasses.field(default_factory=list)
    wire_log: List[tuple] = dataclasses.field(default_factory=list)
    occupancy_log: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)
    stalls: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)
    max_outstanding: int = 0
    high_water_time: float = 0.0
    tracer: Any = NULL_TRACER           # obs.Tracer (model-time track)
    track: str = "dma"
    ts_offset: float = 0.0              # model-time offset of this run in
                                        # the trace (batches lay out
                                        # sequentially, not on top of 0)
    _wire_busy_until: float = 0.0

    def enqueue(self, now: float, nbytes: int) -> float:
        """Enqueue at PE-time `now`; returns completion time of this request.

        Pipelined-channel model: the wire slot serializes (bytes/bandwidth),
        the access latency rides on top and overlaps with other requests.
        """
        # FIFO back-pressure: if fifo_depth requests are still pending at
        # `now`, the PE stalls until a slot frees up.
        wanted = now
        pending = sorted(c for c in self.completions if c > now)
        if len(pending) >= self.fifo_depth:
            now = pending[len(pending) - self.fifo_depth]
            self.stalls.append((wanted, now))
            if self.tracer.enabled:
                self.tracer.complete(
                    self.track, "backpressure", cat="stall",
                    ts=(self.ts_offset + wanted) * 1e6,
                    dur=(now - wanted) * 1e6)
        lat = (self.tier.read_latency if self.direction is Direction.PRELOAD
               else self.tier.write_latency)
        wire_start = max(now, self._wire_busy_until)
        self._wire_busy_until = wire_start + nbytes / self.tier.bandwidth
        done = self._wire_busy_until + lat
        self.completions.append(done)
        self.wire_log.append((now, wire_start, self._wire_busy_until))
        outstanding = 1 + sum(1 for c in self.completions[:-1] if c > now)
        if outstanding > self.max_outstanding:
            self.max_outstanding = outstanding
            self.high_water_time = now      # the occupancy high-water tick
        self.occupancy_log.append((now, outstanding))
        if self.tracer.enabled:
            off = self.ts_offset
            self.tracer.complete(
                self.track, self.direction.name, cat="descriptor",
                ts=(off + now) * 1e6, dur=(done - now) * 1e6,
                nbytes=nbytes, issue=now, complete=done)
            self.tracer.counter(self.track, f"{self.track}:occupancy",
                                outstanding, ts=(off + now) * 1e6)
        return done


@dataclasses.dataclass
class StreamStats:
    """Timeline statistics of one simulated kernel execution."""

    total_time: float
    compute_time: float          # PE time spent on useful compute
    issue_time: float            # PE time spent writing DMA registers
    stall_time: float            # PE time blocked on status-register waits
    bytes_in: int
    bytes_out: int

    @property
    def pe_utilization(self) -> float:
        return self.compute_time / self.total_time if self.total_time else 0.0

    @property
    def io_throughput(self) -> float:
        return (self.bytes_in + self.bytes_out) / self.total_time if self.total_time else 0.0

    @property
    def ipc(self) -> float:
        """Fraction of PE cycles retiring instructions (paper Fig 4-B; DMA
        register writes are real instructions, so they count)."""
        return (self.compute_time + self.issue_time) / self.total_time if self.total_time else 0.0


class DMAEngine:
    """The two-queue engine + PE timeline executor (paper Listing 1)."""

    def __init__(
        self,
        tier: MemoryTier,
        pe: PEModel,
        *,
        fifo_depth: int = 64,
        issue_cycles: int = 12,
        issue_cycles_cached: int = 4,
        wait_poll_cycles: int = 2,
        tracer=None,
    ):
        self.tier = tier
        self.pe = pe
        self.fifo_depth = fifo_depth
        self.issue_cycles = issue_cycles
        self.issue_cycles_cached = issue_cycles_cached
        self.wait_poll_cycles = wait_poll_cycles
        # trace layer (obs): per-channel FIFO occupancy + descriptor
        # spans on model-time tracks; NULL_TRACER = zero overhead
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._trace_clock = 0.0     # model-time offset of the NEXT run's
                                    # events (successive run_stream batches
                                    # lay out sequentially in the trace)

    def _cyc(self, n: float) -> float:
        return n / self.pe.clock_hz

    # ------------------------------------------------------------------ #
    def run_stream(
        self,
        cfg: PULConfig,
        *,
        n_blocks: int,
        block_bytes: int,
        compute_flops_per_block: float,
        unload_bytes_per_block: int = 0,
        interleave: bool = True,
    ) -> StreamStats:
        """Execute the canonical PUL loop (Listing 1) over `n_blocks`.

        `interleave=False` is the paper's baseline: synchronous load ->
        compute -> synchronous flush, no overlap (the "no PL / 1 Tasklet"
        configuration of Experiment 1).

        The plan is statically verified before execution (coverage, issue
        ordering, FIFO discipline — `analysis.plan_verifier`); a
        corrupted plan raises PlanError instead of simulating garbage.
        """
        # imported lazily: analysis.plan_verifier imports core.pul, and a
        # module-level import here would deadlock the package init cycle
        from repro_torch.analysis.plan_verifier import verify_stream_plan
        verify_stream_plan(cfg, n_blocks=n_blocks, block_bytes=block_bytes,
                           engine_fifo_depth=self.fifo_depth)
        tr, off = self.tracer, self._trace_clock
        pre = _Channel(self.tier, Direction.PRELOAD, self.fifo_depth,
                       tracer=tr, track="dma/preload", ts_offset=off)
        unl = _Channel(self.tier, Direction.UNLOAD, self.fifo_depth,
                       tracer=tr, track="dma/unload", ts_offset=off)
        self.last_channels = (pre, unl)     # exposed for invariant tests
        t = 0.0
        compute_t = issue_t = stall_t = 0.0
        compute_per_block = self.pe.compute_time(compute_flops_per_block)

        def issue(ch: _Channel, nbytes: int, first: bool) -> float:
            nonlocal t, issue_t
            dt = self._cyc(self.issue_cycles if first else self.issue_cycles_cached)
            t += dt
            issue_t += dt
            return ch.enqueue(t, nbytes)

        def wait_until(done: float):
            nonlocal t, stall_t
            t += self._cyc(self.wait_poll_cycles)
            if done > t:
                stall_t += done - t
                if tr.enabled:
                    tr.complete("dma/pe", "stall", cat="stall",
                                ts=(off + t) * 1e6, dur=(done - t) * 1e6)
                t = done

        def consume(i: int, pre_done, unl_done):
            nonlocal t, compute_t
            wait_until(pre_done[i])
            if tr.enabled:
                tr.complete("dma/pe", "compute", cat="compute", block=i,
                            ts=(off + t) * 1e6,
                            dur=compute_per_block * 1e6)
            t += compute_per_block
            compute_t += compute_per_block
            if unload_bytes_per_block:
                # scratchpad slot reuse: block i reuses the unload buffer of
                # block i - slots; that flush must have retired first.
                j = i - cfg.num_slots
                if j >= 0:
                    wait_until(unl_done[j])
                unl_done[i] = issue(unl, unload_bytes_per_block, first=(i == 0))
                if cfg.unload_distance == 0:   # synchronous-flush baseline
                    wait_until(unl_done[i])

        def finish() -> StreamStats:
            """Close out the run: advance the trace clock so the next batch
            lays out after this one, and stamp each channel's occupancy
            high-water tick (the executed back-pressure evidence the plan
            verifier cross-checks against its modeled warning)."""
            if tr.enabled:
                for ch in (pre, unl):
                    if ch.occupancy_log:
                        tr.instant(
                            ch.track, "fifo-high-water", cat="fifo",
                            ts=(off + ch.high_water_time) * 1e6,
                            occupancy=ch.max_outstanding,
                            model_time=ch.high_water_time,
                            fifo_depth=ch.fifo_depth,
                            stalled_enqueues=len(ch.stalls))
                self._trace_clock = off + t
            return StreamStats(t, compute_t, issue_t, stall_t,
                               n_blocks * block_bytes,
                               n_blocks * unload_bytes_per_block)

        if not interleave:
            for i in range(n_blocks):
                wait_until(issue(pre, block_bytes, first=(i == 0)))
                t += compute_per_block
                compute_t += compute_per_block
                if unload_bytes_per_block:
                    wait_until(issue(unl, unload_bytes_per_block, first=(i == 0)))
            return finish()

        d = max(1, min(cfg.distance, n_blocks))
        pre_done = [0.0] * n_blocks
        unl_done = [0.0] * n_blocks

        if cfg.strategy is IssueStrategy.BATCH:
            # rounds of d: fire the next batch back-to-back, consume previous
            for i in range(min(d, n_blocks)):
                pre_done[i] = issue(pre, block_bytes, first=(i == 0))
            r = 0
            while r < n_blocks:
                for i in range(r + d, min(r + 2 * d, n_blocks)):
                    pre_done[i] = issue(pre, block_bytes, first=False)
                for i in range(r, min(r + d, n_blocks)):
                    consume(i, pre_done, unl_done)
                r += d
        else:
            # warm-up of d, then alternate PL[i+d] -> compute[i]
            for i in range(min(d, n_blocks)):
                pre_done[i] = issue(pre, block_bytes, first=(i == 0))
            for i in range(n_blocks):
                nxt = i + d
                if nxt < n_blocks:
                    pre_done[nxt] = issue(pre, block_bytes, first=False)
                consume(i, pre_done, unl_done)

        # drain the unload queue (final PRELOAD_WAIT of Listing 1)
        if unload_bytes_per_block and n_blocks:
            wait_until(max(unl_done))
        return finish()

    # ------------------------------------------------------------------ #
    def scale_to_pes(self, single: StreamStats, n_pes: int) -> StreamStats:
        """Aggregate-bandwidth model for K identical PEs (paper Exp. 1/4).

        Each PE replays the single-PE schedule; once the summed demand hits
        the tier bandwidth, execution time dilates by the saturation factor.
        """
        demand = single.io_throughput * n_pes
        dilation = max(1.0, demand / self.tier.bandwidth)
        return StreamStats(
            total_time=single.total_time * dilation,
            compute_time=single.compute_time,
            issue_time=single.issue_time,
            stall_time=single.stall_time + single.total_time * (dilation - 1.0),
            bytes_in=single.bytes_in,
            bytes_out=single.bytes_out,
        )


def speedup(engine: DMAEngine, cfg: PULConfig, **kw) -> float:
    """PUL speedup vs the paper's phase-separated baseline."""
    base = engine.run_stream(cfg, interleave=False, **kw)
    pul = engine.run_stream(cfg, interleave=True, **kw)
    return base.total_time / pul.total_time


# --------------------------------------------------------------------------
# KV-page serving workload (paged-KV engine twin)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KVPageWorkload:
    """Steady-state decode over a paged KV cache, as seen by the DMA twin.

    Each decode step must restore `pages_per_step` cold pages from the slow
    tier while the PE runs attention over the pages already resident; the
    page restores are exactly the paper's preload stream (software knows the
    page list ahead of time — the access pattern is deterministic), so a
    distance-d window hides the restore latency behind per-page attention
    compute. Evicted pages leave through the unload channel.

    Attributes:
      page_bytes: bytes per KV page (page_tokens * packed features * dtype).
      flops_per_page: attention compute consuming one page during one decode
        step (scores + weighted sum over the page's tokens).
      pages_per_step: cold pages restored per decode step.
      steps: decode steps simulated (pages stream back-to-back across steps:
        the engine pipelines restores for step s+1 behind step s's compute).
      unload_pages_per_step: dirty pages written back per step (0 for a
        read-only KV reuse pattern; >0 models eviction write-back).
    """

    page_bytes: int
    flops_per_page: float
    pages_per_step: int = 1
    steps: int = 64
    unload_pages_per_step: int = 0

    @property
    def n_pages(self) -> int:
        return self.pages_per_step * self.steps


def run_kv_page_workload(
    engine: DMAEngine,
    wl: KVPageWorkload,
    *,
    distance: int,
    strategy: IssueStrategy = IssueStrategy.BATCH,
    interleave: bool = True,
) -> StreamStats:
    """Run the paged-KV decode stream on the DMA twin."""
    unload = 0
    if wl.unload_pages_per_step:
        # amortize write-back over the restore stream
        unload = wl.page_bytes * wl.unload_pages_per_step // wl.pages_per_step
    cfg = PULConfig(distance=min(distance, engine.fifo_depth),
                    strategy=strategy, fifo_depth=engine.fifo_depth,
                    unload_distance=1)
    return engine.run_stream(
        cfg,
        n_blocks=wl.n_pages,
        block_bytes=wl.page_bytes,
        compute_flops_per_block=wl.flops_per_page,
        unload_bytes_per_block=unload,
        interleave=interleave,
    )


def kv_page_latency_hidden(engine: DMAEngine, wl: KVPageWorkload,
                           *, distance: int) -> float:
    """Fraction of page-restore *access latency* hidden at `distance`.

    The hideable quantity is the per-request access latency (the paper's
    point: bandwidth is a serial floor, latency pipelines away once the
    preload window covers it). We measure the PE stall the preload schedule
    removes relative to the phase-separated baseline, normalized by the
    total access latency of the stream:

        hidden = (stall_baseline - stall_pul) / (n_pages * read_latency)

    clamped to [0, 1] (overlap can also hide bandwidth time behind compute,
    pushing the raw ratio past 1). 1.0 = the PE never waits on a restore
    beyond the bandwidth floor; 0.0 = every restore pays its full latency.
    """
    base = run_kv_page_workload(engine, wl, distance=distance,
                                interleave=False)
    pul = run_kv_page_workload(engine, wl, distance=distance)
    latency_exposure = wl.n_pages * engine.tier.read_latency
    if latency_exposure <= 0:
        return 1.0
    saved = base.stall_time - pul.stall_time
    return max(0.0, min(1.0, saved / latency_exposure))
