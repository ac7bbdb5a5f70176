"""Static verification of PUL preload plans before execution.

A copy of the reference package's ``analysis/plan_verifier.py``.

``core.planner.plan_stream`` / ``plan_kv_page_stream`` emit a
:class:`~repro_torch.core.pul.PULConfig` that ``DMAEngine.run_stream`` then
executes over ``n_blocks`` blocks. A malformed plan — distance outside the
FIFO window, an issue schedule that consumes a block before its preload was
ever requested, a schedule that skips blocks — silently produces wrong
timings (and, on real hardware, wrong *data*). This module validates a plan
purely statically: it derives the exact issue/consume order the engine will
use (mirroring the two ``IssueStrategy`` schedules symbolically, no
simulation clock involved) and checks

  * config sanity: distance >= 1, within both the plan's and the executing
    engine's FIFO depth; enough scratchpad slots to keep every in-flight
    block resident; non-negative unload distance; positive block size;
  * ordering: every consumed block's preload was issued (and, because the
    engine waits on the completion register before consuming, completed)
    strictly before its consume;
  * coverage: every block in [0, n_blocks) is consumed exactly once;
  * capacity: the deepest in-flight preload window never exceeds the
    scratchpad slot count, and FIFO overflow (BATCH's 2d window past the
    queue depth) is reported as a stall warning.

``DMAEngine.run_stream`` calls :func:`verify_stream_plan` as a
precondition; ``repro_torch.benchmarks.kv_page_dma`` verifies the planner's
output before sweeping it. Errors raise :class:`PlanError`; warnings ride along in
the returned :class:`PlanReport`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.pul import IssueStrategy, PULConfig


class PlanError(ValueError):
    """A preload plan failed static verification; executing it would break
    the FIFO/ordering contract (or read unfetched data on real hardware)."""


@dataclasses.dataclass(frozen=True)
class PlanReport:
    """Outcome of a static plan verification."""

    distance: int
    n_blocks: int
    max_in_flight: int              # deepest preload window in the schedule
    warnings: Tuple[str, ...] = ()

    @property
    def ok(self) -> bool:           # errors raise; a report means verified
        return True


def _schedule(cfg: PULConfig, n_blocks: int) -> List[Tuple[str, int]]:
    """The exact (op, block) order run_stream will execute, symbolically.

    Ops are ("issue", i) — preload of block i enqueued — and
    ("consume", i) — block i's compute, which waits on preload i first.
    Mirrors ``DMAEngine.run_stream``'s two strategies.
    """
    d = max(1, min(cfg.distance, n_blocks))
    sched: List[Tuple[str, int]] = []
    if cfg.strategy is IssueStrategy.BATCH:
        for i in range(min(d, n_blocks)):
            sched.append(("issue", i))
        r = 0
        while r < n_blocks:
            for i in range(r + d, min(r + 2 * d, n_blocks)):
                sched.append(("issue", i))
            for i in range(r, min(r + d, n_blocks)):
                sched.append(("consume", i))
            r += d
    else:
        for i in range(min(d, n_blocks)):
            sched.append(("issue", i))
        for i in range(n_blocks):
            nxt = i + d
            if nxt < n_blocks:
                sched.append(("issue", nxt))
            sched.append(("consume", i))
    return sched


def verify_stream_plan(
    cfg: PULConfig,
    *,
    n_blocks: int,
    block_bytes: int,
    engine_fifo_depth: Optional[int] = None,
) -> PlanReport:
    """Statically validate one preload plan; raises PlanError on violation.

    ``engine_fifo_depth`` is the FIFO depth of the engine that will execute
    the plan — a plan may carry a deeper ``cfg.fifo_depth`` than the
    hardware it lands on, which ``PULConfig.__post_init__`` cannot know.
    """
    if n_blocks < 0:
        raise PlanError(f"n_blocks must be >= 0, got {n_blocks}")
    if block_bytes <= 0:
        raise PlanError(f"block_bytes must be positive, got {block_bytes}")
    if not isinstance(cfg.strategy, IssueStrategy):
        raise PlanError(f"unknown issue strategy {cfg.strategy!r}")
    d = cfg.distance
    if d < 1:
        raise PlanError(f"preload distance must be >= 1, got {d}")
    if d > cfg.fifo_depth:
        raise PlanError(
            f"preload distance {d} exceeds the plan's FIFO depth "
            f"{cfg.fifo_depth}: the warm-up window can never be in flight")
    if engine_fifo_depth is not None and d > engine_fifo_depth:
        raise PlanError(
            f"preload distance {d} exceeds the executing engine's FIFO "
            f"depth {engine_fifo_depth}")
    if cfg.unload_distance < 0:
        raise PlanError(
            f"unload distance must be >= 0, got {cfg.unload_distance}")
    if cfg.num_slots < min(d, max(n_blocks, 1)):
        raise PlanError(
            f"{cfg.num_slots} scratchpad slots cannot hold the {d}-deep "
            "preload window: an in-flight block would overwrite a block "
            "still awaiting its compute")
    if any(s <= 0 for s in cfg.block_shape):
        raise PlanError(f"block_shape must be positive, got {cfg.block_shape}")

    sched = _schedule(cfg, n_blocks)
    issued = set()
    consumed = set()
    in_flight = 0
    max_in_flight = 0
    for op, i in sched:
        if op == "issue":
            if i in issued:
                raise PlanError(f"block {i} preloaded twice")
            issued.add(i)
            in_flight += 1
            max_in_flight = max(max_in_flight, in_flight)
        else:
            if i not in issued:
                raise PlanError(
                    f"block {i} consumed with no preceding preload: the "
                    "compute would read unfetched data")
            if i in consumed:
                raise PlanError(f"block {i} consumed twice")
            consumed.add(i)
            in_flight -= 1
    missing = set(range(n_blocks)) - consumed
    if missing:
        raise PlanError(
            f"schedule does not cover the block set: blocks "
            f"{sorted(missing)[:8]}{'...' if len(missing) > 8 else ''} "
            "are never consumed")
    if issued - set(range(n_blocks)):
        raise PlanError("schedule preloads blocks outside [0, n_blocks)")

    warnings = []
    fifo = min(cfg.fifo_depth, engine_fifo_depth
               if engine_fifo_depth is not None else cfg.fifo_depth)
    if max_in_flight > fifo:
        warnings.append(
            f"in-flight preload window peaks at {max_in_flight} > FIFO "
            f"depth {fifo}: enqueue will back-pressure the PE (modeled as "
            "a stall, legal but slow)")
    if max_in_flight > cfg.num_slots:
        raise PlanError(
            f"in-flight window {max_in_flight} exceeds the {cfg.num_slots} "
            "scratchpad slots: a preload would land on live data")
    return PlanReport(distance=d, n_blocks=n_blocks,
                      max_in_flight=max_in_flight,
                      warnings=tuple(warnings))


def diff_fifo_occupancy(cfg: PULConfig, *, n_blocks: int, channel,
                        engine_fifo_depth: Optional[int] = None) -> List[str]:
    """Diff a PRELOAD channel's *executed* FIFO occupancy against the
    symbolic schedule (the ROADMAP "trace the DMA twin itself" item).

    `channel` is a ``core.dma._Channel`` after an interleaved
    ``run_stream`` (its ``occupancy_log`` samples (model_time, outstanding)
    at every enqueue; ``max_outstanding``/``high_water_time`` carry the
    occupancy high-water tick; ``stalls`` the back-pressure intervals).
    The symbolic side is the same :func:`_schedule` the static verifier
    replays. Returns divergence strings (empty list = the executed
    schedule matches the model):

      * enqueue counts must match the schedule's issue ops 1:1;
      * at the k-th enqueue, executed occupancy (enqueued-not-completed)
        can never exceed the symbolic in-flight window (issued-not-
        consumed) clamped to the FIFO depth — consume waits on the
        completion register, so a deeper executed queue means the engine
        consumed a block whose preload never retired;
      * the occupancy high-water must stay within the symbolic peak;
      * back-pressure must appear in the execution exactly when the static
        verifier modeled it (window > FIFO depth <=> a stalled enqueue).

    Early completions legally make the executed occupancy *shallower* than
    the window (the wire can finish a transfer before its block's turn);
    only exceeding the model is a divergence.
    """
    sched = _schedule(cfg, n_blocks)
    bounds: List[int] = []              # symbolic window after each issue
    in_flight = 0
    peak = 0
    for op, _ in sched:
        if op == "issue":
            in_flight += 1
            peak = max(peak, in_flight)
            bounds.append(in_flight)
        else:
            in_flight -= 1
    fifo = min(cfg.fifo_depth, engine_fifo_depth
               if engine_fifo_depth is not None else cfg.fifo_depth)
    divs: List[str] = []
    log = list(channel.occupancy_log)
    if len(log) != len(bounds):
        divs.append(
            f"executed {len(log)} enqueues but the symbolic schedule "
            f"issues {len(bounds)} preloads")
    for k, ((t, occ), bound) in enumerate(zip(log, bounds)):
        cap = min(bound, fifo)
        if occ > cap:
            divs.append(
                f"enqueue #{k} (model t={t:.3e}): executed occupancy {occ} "
                f"exceeds the symbolic in-flight window {cap}")
    symbolic_peak = min(peak, fifo)
    if channel.max_outstanding > symbolic_peak:
        divs.append(
            f"occupancy high-water {channel.max_outstanding} at model "
            f"t={channel.high_water_time:.3e} exceeds the symbolic peak "
            f"{symbolic_peak}")
    modeled_bp = peak > fifo
    executed_bp = bool(channel.stalls)
    if modeled_bp and not executed_bp:
        divs.append(
            f"verifier modeled back-pressure (window {peak} > FIFO {fifo}) "
            "but no enqueue ever stalled in the execution")
    if executed_bp and not modeled_bp:
        divs.append(
            f"{len(channel.stalls)} enqueue(s) hit FIFO back-pressure but "
            f"the symbolic window ({peak}) never exceeds the FIFO depth "
            f"({fifo})")
    return divs


def verify_kv_page_plan(plan, *, n_pages: int, page_bytes: int,
                        engine_fifo_depth: Optional[int] = None) -> PlanReport:
    """Validate a ``core.planner.Plan`` for a KV-page restore stream.

    Beyond the stream checks, a page plan must be self-consistent: the
    predicted per-block time can never undercut the roofline legs it was
    derived from.
    """
    cfg = plan.cfg
    report = verify_stream_plan(cfg, n_blocks=n_pages,
                                block_bytes=page_bytes,
                                engine_fifo_depth=engine_fifo_depth)
    eps = 1e-12
    if plan.t_compute_per_block < 0 or plan.t_io_per_block < 0:
        raise PlanError("plan carries negative per-block times")
    if plan.predicted_time_per_block + eps < plan.t_compute_per_block:
        raise PlanError(
            "plan predicts a per-block time below its own compute time: "
            f"{plan.predicted_time_per_block} < {plan.t_compute_per_block}")
    return report
