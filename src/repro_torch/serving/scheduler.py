"""Admission control for the paged serving engine.

Token-budget continuous batching with pluggable scheduling policies:

  * ``fcfs``     — strict FIFO (the original behavior): the head of the
    queue blocks later requests, keeping queue-latency semantics
    predictable. Never preempts.
  * ``priority`` — higher ``Request.priority`` admits first; the engine
    preempts lower-priority *running* requests (vLLM-style swap-out to the
    cold tier) when a higher-priority arrival cannot be admitted.
  * ``slo-edf``  — earliest-deadline-first on per-request TTFT deadlines
    (``Request.ttft_deadline``, in engine ticks from submit). Requests that
    already emitted their first token have no pending deadline and sort
    last; the engine preempts only when a pending deadline would otherwise
    be missed.

A request is admitted into a free slot when (a) a slot is free, (b) the
batch's token budget — the sum over live slots of worst-case final length
(full prompt + max_new_tokens) — stays within ``max_active_tokens``, and
(c) the paged KV pool has hot frames for its worst-case page count.
Admission picks the smallest prefill bucket that fits the prompt
(prefix-length bucketing: one compiled prefill per bucket serves all
lengths in it). Prompts longer than the largest configured bucket use
``max_seq`` as an implicit top bucket — they are never silently truncated;
prompts that cannot fit a slot at all are rejected, not queued.

Queue latency (submit tick -> admit tick) is recorded per request at FIRST
admission (a preempted request's readmission wait is tracked separately via
``Request.preemptions``) and surfaced through the engine's metrics hook.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.obs.tracer import NULL_TRACER

POLICIES = ("fcfs", "priority", "slo-edf")


@dataclasses.dataclass
class Request:
    """One generation request (also used by the dense reference engine)."""

    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    priority: int = 0               # higher = more important (priority policy)
    ttft_deadline: int = -1         # ticks from submit to first token
                                    # (-1: no SLO; slo-edf policy)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    failed: bool = False            # never-admittable: rejected, not served
    error: str = ""
    # paged-engine bookkeeping
    submit_tick: int = -1
    admit_tick: int = -1
    first_token_tick: int = -1
    bucket: int = 0
    preemptions: int = 0            # times swapped out mid-flight
    resuming: bool = False          # requeued after preemption (pages saved)
    _seq: int = -1                  # scheduler arrival order (stable ties)

    @property
    def queue_latency(self) -> int:
        """Engine ticks spent queued before admission (-1: never admitted)."""
        if self.admit_tick < 0:
            return -1
        return self.admit_tick - self.submit_tick

    @property
    def ttft(self) -> int:
        """Ticks from submit to first emitted token (-1: none yet)."""
        if self.first_token_tick < 0:
            return -1
        return self.first_token_tick - self.submit_tick

    def deadline_tick(self) -> float:
        """Absolute tick by which the first token must be emitted (inf:
        no deadline, or the first token is already out — a TTFT deadline
        stops mattering the moment TTFT is fixed)."""
        if self.ttft_deadline < 0 or self.first_token_tick >= 0:
            return math.inf
        return self.submit_tick + self.ttft_deadline


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    prefill_buckets: Tuple[int, ...] = (16, 32, 64)
    max_active_tokens: int = 0          # 0 -> unlimited (slots are the cap)
    page_tokens: int = 16
    policy: str = "fcfs"
    max_seq: int = 0                    # implicit top bucket for prompts
                                        # longer than the largest configured
                                        # bucket (0 -> largest bucket is the
                                        # hard cap)

    def __post_init__(self):
        if not self.prefill_buckets:
            raise ValueError("need at least one prefill bucket")
        if tuple(sorted(self.prefill_buckets)) != tuple(self.prefill_buckets):
            raise ValueError("prefill_buckets must be ascending")
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")


@dataclasses.dataclass(frozen=True)
class Admission:
    slot: int
    request: Request
    bucket: int


class AdmissionScheduler:
    def __init__(self, cfg: SchedulerConfig, tracer=None):
        self.cfg = cfg
        # obs tracer: every admission outcome is an instant on the
        # "sched" track with its machine-readable reason — what
        # tools/trace_diff.py aligns two runs on
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.queue: List[Request] = []
        self.failed: List[Request] = []     # never-admittable rejections
        self.rejected = 0
        # latency VALUES, not Request objects: admitted requests must not be
        # retained here forever (prompt/out_tokens would leak in a
        # long-lived engine)
        self._latencies: List[int] = []
        self._arrivals = 0

    def __len__(self) -> int:
        return len(self.queue)

    # ------------------------------------------------------------------ #
    def submit(self, req: Request, now: int):
        req.submit_tick = now
        req._seq = self._arrivals
        self._arrivals += 1
        self.queue.append(req)

    def requeue(self, req: Request, now: int):
        """Return a preempted (swapped-out) request to the queue. It keeps
        its original submit tick and arrival order, so among equal policy
        keys it readmits before later arrivals."""
        req.resuming = True
        req.preemptions += 1
        self.queue.append(req)
        self._sort()

    def pick_bucket(self, prompt_len: int) -> int:
        for b in self.cfg.prefill_buckets:
            if prompt_len <= b:
                return b
        top = self.cfg.prefill_buckets[-1]
        if self.cfg.max_seq > top:
            return self.cfg.max_seq     # implicit top bucket: never truncate
        return top

    def request_cost(self, req: Request) -> int:
        """Worst-case final token count (budget unit).

        THE cost function of the token budget: submit-time rejection,
        admission, and the engine's per-tick accounting
        (`PagedServingEngine._active_tokens`) all charge this — one
        definition, so the budget can never drift between checks. Charges
        the TRUE prompt length: a prompt longer than the largest prefill
        bucket is served through the implicit ``max_seq`` bucket, never
        silently truncated, so under-charging it would let admission
        oversubscribe both the token budget and the page pool."""
        return len(req.prompt) + req.max_new_tokens

    def request_pages(self, req: Request) -> int:
        P = self.cfg.page_tokens
        return -(-self.request_cost(req) // P)

    # ------------------------------------------------------------------ #
    def _order_key(self, req: Request):
        if self.cfg.policy == "priority":
            return (-req.priority, req._seq)
        if self.cfg.policy == "slo-edf":
            return (req.deadline_tick(), req._seq)
        return (req._seq,)

    def _sort(self):
        # fcfs keys on arrival order, so this is a no-op there except after
        # a requeue, where it reinserts the preempted request at its
        # original position instead of the back
        self.queue.sort(key=self._order_key)

    def head(self) -> Optional[Request]:
        """Most-urgent queued request under the configured policy."""
        self._sort()
        return self.queue[0] if self.queue else None

    def _fail(self, req: Request, reason: str):
        req.failed = True
        req.done = True
        req.error = reason
        self.failed.append(req)
        self.rejected += 1
        if self.tracer.enabled:
            self.tracer.decision("reject", rid=req.rid, reason=reason)
            # close the request's lifecycle span (opened at engine submit)
            self.tracer.async_end("requests", f"req{req.rid}", req.rid,
                                  cat="request", failed=True)

    # ------------------------------------------------------------------ #
    def admit(
        self,
        free_slots: Sequence[int],
        *,
        active_tokens: int,
        free_hot_frames: int,
        now: int,
        total_hot_frames: Optional[int] = None,
    ) -> List[Admission]:
        """Policy-ordered admission under slot / token / page budgets.

        Head-blocking within the policy order: the most-urgent queued
        request blocks later ones (no reordering past it), keeping latency
        semantics predictable — preemptive policies make room by evicting
        running requests (engine side), not by skipping the head.

        A head request that can NEVER be admitted — its page demand exceeds
        the pool's TOTAL hot frames, or its cost exceeds the whole token
        budget — is failed visibly (``Request.failed``, ``self.failed``,
        the ``rejected`` counter) instead of blocking the queue forever:
        waiting cannot make an impossible demand feasible, and a silent
        head-of-queue wedge starves every request behind it.
        """
        out: List[Admission] = []
        free = list(free_slots)
        budget = self.cfg.max_active_tokens
        tokens = active_tokens
        frames = free_hot_frames
        self._sort()
        while self.queue and free:
            req = self.queue[0]
            cost = self.request_cost(req)
            pages = self.request_pages(req)
            if total_hot_frames is not None and pages > total_hot_frames:
                self.queue.pop(0)
                self._fail(req, f"needs {pages} pages; pool holds only "
                                f"{total_hot_frames} hot frames in total")
                continue
            if budget and cost > budget:
                self.queue.pop(0)
                self._fail(req, f"costs {cost} tokens; the whole budget is "
                                f"{budget}")
                continue
            if budget and tokens + cost > budget:
                if self.tracer.enabled:
                    self.tracer.decision(
                        "admission-blocked", rid=req.rid,
                        reason="token-budget", cost=cost,
                        active_tokens=tokens, budget=budget)
                break
            if pages > frames:
                if self.tracer.enabled:
                    self.tracer.decision(
                        "admission-blocked", rid=req.rid,
                        reason="no-hot-frames", pages=pages,
                        free_frames=frames)
                break
            self.queue.pop(0)
            req.admit_tick = now
            req.bucket = self.pick_bucket(len(req.prompt))
            tokens += cost
            frames -= pages
            slot = free.pop(0)
            out.append(Admission(slot=slot, request=req, bucket=req.bucket))
            if self.tracer.enabled:
                self.tracer.decision(
                    "admit", rid=req.rid, slot=slot, bucket=req.bucket,
                    policy=self.cfg.policy, resuming=req.resuming)
            if not req.resuming:
                # queue latency is anchored at FIRST admission; readmission
                # waits are visible via Request.preemptions instead
                self._latencies.append(req.queue_latency)
        return out

    # ------------------------------------------------------------------ #
    def queue_latencies(self) -> List[int]:
        return [l for l in self._latencies if l >= 0]
