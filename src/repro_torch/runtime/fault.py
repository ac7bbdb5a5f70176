"""Fault tolerance, straggler detection, elastic rescale (port of
``repro/runtime/fault.py``; pure Python, the reference's code).

* **Crash/restart**: training state is (params, opt, step); checkpoints are
  atomic-commit and the data pipeline is a pure function of (seed, step), so
  restart = restore latest + `skip_to(step)` — no coordination files.
* **Heartbeats / failure detection**: `HeartbeatMonitor` tracks per-worker
  liveness with a deadline; the trainer loop feeds it its step times.
* **Straggler detection**: robust z-score over a sliding window of step
  times (median/MAD); a persistent outlier marks the worker for eviction.
* **Elastic rescale**: `rescale_plan(old, new)` computes the new mesh and
  the resharding strategy, keeping the global batch by scaling the
  gradient-accumulation steps. The port trains on one device; the plan is
  the reference's arithmetic, kept for the mesh work.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class WorkerState:
    last_seen: float
    step_times: Deque[float]


class HeartbeatMonitor:
    def __init__(self, deadline_s: float = 60.0, window: int = 32):
        self.deadline_s = deadline_s
        self.window = window
        self.workers: Dict[str, WorkerState] = {}

    def beat(self, worker: str, step_time: Optional[float] = None,
             now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        st = self.workers.setdefault(
            worker, WorkerState(now, deque(maxlen=self.window)))
        st.last_seen = now
        if step_time is not None:
            st.step_times.append(step_time)

    def dead_workers(self, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        return [w for w, st in self.workers.items()
                if now - st.last_seen > self.deadline_s]

    def stragglers(self, *, z_threshold: float = 4.0, min_samples: int = 8
                   ) -> List[str]:
        """Median/MAD outlier detection over recent step times."""
        all_medians = []
        per_worker = {}
        for w, st in self.workers.items():
            if len(st.step_times) >= min_samples:
                xs = sorted(st.step_times)
                per_worker[w] = xs[len(xs) // 2]
                all_medians.append(per_worker[w])
        if len(all_medians) < 2:
            return []
        xs = sorted(all_medians)
        med = xs[len(xs) // 2]
        mad = sorted(abs(x - med) for x in xs)[len(xs) // 2] or 1e-9
        return [w for w, m in per_worker.items()
                if (m - med) / (1.4826 * mad) > z_threshold]


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    old_mesh: Tuple[int, ...]
    new_mesh: Tuple[int, ...]
    new_axes: Tuple[str, ...]
    batch_scale: float              # keep tokens/step constant via accum
    action: str


def rescale_plan(n_pods_old: int, n_pods_new: int) -> RescalePlan:
    """Elastic plan when pods join/leave. Data-parallel scale changes; the
    in-pod (data, model) topology is fixed at (16, 16); global batch is
    preserved by scaling gradient-accumulation steps."""
    if n_pods_new < 1:
        raise ValueError("cannot rescale to zero pods")
    if n_pods_new == 1:
        mesh, axes = (16, 16), ("data", "model")
    else:
        mesh, axes = (n_pods_new, 16, 16), ("pod", "data", "model")
    old = (n_pods_old, 16, 16) if n_pods_old > 1 else (16, 16)
    return RescalePlan(
        old_mesh=old, new_mesh=mesh, new_axes=axes,
        batch_scale=n_pods_old / n_pods_new,
        action=("restore latest checkpoint with new-mesh shardings; "
                "multiply accum by batch_scale; data.skip_to(step)"),
    )
