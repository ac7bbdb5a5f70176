"""Serving engines (port of ``repro/serving/engine.py``): the dense
reference engine and paged, PUL-tiered continuous batching.

:class:`ServingEngine` is the dense-cache reference: a fixed pool of B slots
over monolithic per-slot KV that never leaves device memory, left-padded
bucket prefill, and a re-prefill of the whole batch on admission. It is the
differential-test oracle of the paged engine.

:class:`PagedServingEngine` serves a model from a paged KV cache: KV lives in
fixed-size pages managed by the PUL page pool (``serving.kv_pages``),
requests are admitted by a token-budget scheduler (``serving.scheduler``),
slots refill per step without touching their neighbours, same-bucket
requests sharing a page-aligned prompt prefix share prompt pages, and cold
pages ride UNLOAD/PRELOAD descriptors planned at the paper's d* distance.

Decode is kernel-true by default (``use_paged_kernel=True``): attention
streams straight over the page frames, the page table acting as the preload
trace, with the current token's K/V merged into the online softmax
in-kernel. Two equivalent paths:

  * ``sweep_decode=True`` (default): every layer runs the sweep kernel (K1;
    K3 for MLA models) over the full per-layer planes and commits the
    token's rows in its epilogue, in place;
  * ``sweep_decode=False``: every layer runs the per-layer kernel (K2; K4
    for MLA) over its own frames and the engine commits the rows afterwards
    (``KVPagePool.write_rows``) — the parity baseline. Both paths give
    bitwise-identical token streams.

``use_paged_kernel=False`` decodes by **assembly**, the reference's oracle
path: the planes are packed into the ``(NF, P, F)`` store, each slot's pages
are gathered by page table into a dense ``(B, S, F)`` view — through the PUL
gather kernel K5 with ``use_pallas_gather=True`` — unpacked into a dense
cache tree, decoded by the model's dense step, and the step's new rows are
written back into the tail pages. Its dense attention sums in another order
than K1/K2, so its tokens agree with the kernel-true paths only up to bf16
near-ties; the two gather routes agree bitwise.

Fully-shared prompts skip prefill compute: when a request's whole
page-aligned prompt already lives in shared pages, admission refs the pages
and replays the cached first-token logits (``prefill_skips``).

Scheduling is policy-driven (``fcfs`` | ``priority`` | ``slo-edf``); the
latter two preempt running requests, whose private pages spill to the cold
tier (host memory) and come back through planned restores on readmission.
Chunked prefill (``prefill_chunk_tokens > 0``) fills long prompts one
page-aligned chunk per tick, interleaved with decode. Prompts of more than
2 * KV_BLOCK = 2048 tokens (a bucket past 2048, monolithic or a chunk pass
over the prefix so far) stream their prefill attention over KV blocks
(``models.layers._attend_chunked``), as the reference does.

On the card the kernel-true decode step (sweep or per layer) is one CUDA
graph (``serving.capture``), the counterpart of the reference's ``jax.jit``
of the step: each tick the host half (admission, page residency, the page
table, lengths, commit frames and offsets) fills one int32 buffer, which
one copy moves into a fixed device buffer; the device half reads only that
buffer, the weights and the planes. It is captured at the engine's first
decode step and replayed every tick; ``capture_decode=False`` runs the same
device half eagerly (the counterpart of ``jax.disable_jit``), as the CPU
always does. The assembly path stays eager.

The page table that the step reads is kept across ticks: row i holds the
frames of slot i's pages, and only what changes is rewritten. A new tail
page writes its one entry; any other change of a slot's pages (prefill,
shared-prefix admission, a chunk pass, a resume) marks its row, as does a
page of the row moving tier (``pool.take_moved``); a marked row is
rewritten from the slot's pages when the slot next decodes
(``gauges/page_rows_rebuilt`` counts them). With the pool's trace off a
steady tick then costs O(slots) in Python: the tail pages, restores only
where a page is cold (``pool.restore_cold``), one touch of the table's
frames and one copy of the live rows. With the trace on (``shadow_check``)
the tick walks every page as the reference does (``pool.ensure_hot``,
``pool.frames_of``: a TOUCH and a READ per page) and holds each kept row
to what that walk reads.

With a ``Tracer`` that records, each decode tick's ``engine/decode`` span
holds five phases, in order: ``decode_pages`` (tail pages, restores, the
kept page table), ``decode_fill`` (the step buffer and its copy),
``decode_launch`` (the commit's accounting and the step's enqueue),
``decode_wait`` (the logits' copy to the host and its wait) and
``decode_emit`` (the tokens); on the card the kernel-true step's device
time, from CUDA events (``serving.capture.StepTimer``), becomes a
``device/decode_step`` span on the same clock and a
``gauges/device_step_ms`` counter. Without one, no event is made.

A recurrent model's state (rwkv6's WKV state and token-shift carries,
zamba2's Mamba h and conv state) is not pageable: it lives in ``resident``,
one tree of the non-pageable cache leaves only, with one row per slot, at
fixed addresses. Each prefill's state is copied into its slot's rows
(after a monolithic prefill, and after the final chunk pass only), each
decode step's new state replaces every row (paused and empty slots ride
through the batched step with token 0 and advance, as in the reference),
and ``preempt``/``resume`` and the swap-out and readmission of a preempted
request snapshot and write back the slot's rows. Pages cannot rebuild that
state, so a recurrent model never skips prefill. A model without pageable
KV (rwkv6) decodes by the dense decode step over ``resident`` whatever the
path (the reference's route with zero features), eagerly.

``shadow_check=True`` records the pool's page-lifecycle trace and replays
each tick's new events through ``analysis.sanitizer.LifecycleChecker`` at
the end of the tick, after the decode step (and its replay) has run,
raising ``LifecycleViolationError`` at the tick that broke the contract.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis.sanitizer import (
    LifecycleChecker,
    LifecycleViolationError,
)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.pul import (
    H100_HBM,
    H100_PINNED_HOST,
    H100_SM,
    MemoryTier,
    PEModel,
    PULConfig,
)
from repro_torch.kernels.pul_gather import pul_page_gather
from repro_torch.models import transformer as T
from repro_torch.models.module import flatten
from repro_torch.models.zoo import Model
from repro_torch.obs.metrics import (
    MetricsRegistry,
    cache_economics,
    economics_into_registry,
)
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.serving.capture import CapturedStep, StepTimer
from repro_torch.serving.kv_pages import (
    KVPagePool,
    PackedKVLayout,
    PageConfig,
    TRASH_FRAME,
    ZERO_FRAME,
    _leaves,
)
from repro_torch.serving.scheduler import (
    Admission,
    AdmissionScheduler,
    Request,
    SchedulerConfig,
)


def percentile(xs, q: float) -> float:
    """q-th percentile (linear interpolation) as a plain float; 0.0 for an
    empty sample, so a metrics snapshot of a run that emitted nothing
    cannot take the engine down."""
    xs = list(xs)
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs, np.float64), q))


def mean(xs) -> float:
    """Mean as a plain float; 0.0 for an empty sample."""
    xs = list(xs)
    if not xs:
        return 0.0
    return float(np.mean(np.asarray(xs, np.float64)))


def _slot_row(keys: Tuple[str, ...], leaf: torch.Tensor,
              slot: int) -> torch.Tensor:
    """One slot's row of a cache leaf (a view): batch axis 1 under the
    groups' layer axis, 0 for a dense layer's leaf."""
    return leaf.select(1 if keys[0] == "groups" else 0, slot)


def _put(tree: Dict[str, Any], keys: Tuple[str, ...], leaf) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = leaf


def _drain_results(requests: Dict[int, Request]) -> Dict[int, List[int]]:
    """Collect every tracked request's output and prune the completed ones."""
    out = {rid: r.out_tokens for rid, r in requests.items()}
    for rid in [rid for rid, r in requests.items() if r.done]:
        del requests[rid]
    return out


# ========================================================================== #
# dense reference engine
# ========================================================================== #
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch_slots: int = 4
    max_seq: int = 256
    prefill_bucket: int = 64
    greedy: bool = True
    sample_seed: int = 0            # rng seed for greedy=False sampling
                                    # (PagedEngineConfig.sample_seed's twin)
    device: str = "cuda"            # caches and weights


class ServingEngine:
    """Dense-cache slot engine (left-padded bucket prefill, batch re-prefill
    on admission). The differential-test oracle for the paged engine."""

    def __init__(self, cfg: ModelConfig, params,
                 engine_cfg: EngineConfig = EngineConfig()):
        from repro_torch.serving.config import ServingConfig
        if isinstance(engine_cfg, ServingConfig):
            engine_cfg = engine_cfg.dense()
        self.device = resolve_device(engine_cfg.device)
        T.check_supported(cfg)
        self.model_cfg = cfg
        self.cfg = engine_cfg
        self.model = Model(cfg, params)
        self.params = params
        B = engine_cfg.batch_slots
        self.caches = None
        self.slot_req: List[Optional[Request]] = [None] * B
        self.slot_pos = np.zeros((B,), np.int64)    # next position per slot
        self.queue: List[Request] = []
        self.requests: Dict[int, Request] = {}     # every request submitted
        self._rng = np.random.default_rng(engine_cfg.sample_seed)

    # ------------------------------------------------------------------ #
    def submit(self, req: Request):
        self.requests[req.rid] = req
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self):
        """Fill free slots; (re)prefill the whole batch when admitting (one
        prefill shape; admission costs a batch prefill)."""
        free = self._free_slots()
        if not free or not self.queue:
            return
        while free and self.queue:
            self.slot_req[free.pop(0)] = self.queue.pop(0)
        self._prefill_all()

    def _prefill_all(self):
        B, bucket = self.cfg.batch_slots, self.cfg.prefill_bucket
        toks = np.zeros((B, bucket), np.int64)
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            prompt = (r.prompt + r.out_tokens)[-bucket:]
            toks[i, bucket - len(prompt):] = prompt       # left-pad
            self.slot_pos[i] = bucket
        logits, self.caches = self.model.prefill(
            torch.as_tensor(toks, device=self.device), max_seq=self.cfg.max_seq)
        self._emit(logits.cpu().numpy())

    def _emit(self, logits: np.ndarray):
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            if self.cfg.greedy:
                nxt = int(np.argmax(logits[i]))
            else:
                z = logits[i].astype(np.float64) - logits[i].max()
                p = np.exp(z)
                nxt = int(self._rng.choice(p.shape[-1], p=p / p.sum()))
            r.out_tokens.append(nxt)
            if len(r.out_tokens) >= r.max_new_tokens:
                r.done = True
                self.slot_req[i] = None

    # ------------------------------------------------------------------ #
    def step(self):
        """One engine tick: admit + one decode step for all live slots."""
        self._admit()
        if self.caches is None or all(r is None for r in self.slot_req):
            return
        B = self.cfg.batch_slots
        toks = np.zeros((B, 1), np.int64)
        for i, r in enumerate(self.slot_req):
            if r is not None and r.out_tokens:
                toks[i, 0] = r.out_tokens[-1]
        batch = {"tokens": torch.as_tensor(toks, device=self.device),
                 "pos0": torch.as_tensor(self.slot_pos, device=self.device)}
        logits, self.caches = self.model.decode_step(batch, self.caches)
        self.slot_pos = self.slot_pos + 1
        self._emit(logits.cpu().numpy())

    def run(self, max_ticks: int = 1000) -> Dict[int, List[int]]:
        """Drive steps until every tracked request completes (or the tick
        cap); returns {rid: generated tokens} for ALL submitted requests,
        including those admitted before run() was called."""
        ticks = 0
        pending = lambda: self.queue or any(r is not None for r in self.slot_req)
        while pending() and ticks < max_ticks:
            self.step()
            ticks += 1
        return _drain_results(self.requests)


# ========================================================================== #
# paged engine
# ========================================================================== #
@dataclasses.dataclass(frozen=True)
class PagedEngineConfig:
    batch_slots: int = 4
    max_seq: int = 256
    page_tokens: int = 16
    hot_pages: int = 0              # 0 -> size for every live slot resident
    prefill_buckets: Tuple[int, ...] = (16, 32, 64)
    max_active_tokens: int = 0      # 0 -> slots * max_seq
    preload_distance: Optional[int] = None   # None -> planner d*
    share_prefix_pages: bool = True
    use_pallas_gather: bool = False  # assembly path: gather through K5
    use_paged_kernel: bool = True    # kernel-true decode; False: assembly
    sweep_decode: bool = True        # K1 fused sweep; False: K2 per layer
    policy: str = "fcfs"            # "fcfs" | "priority" | "slo-edf"
    prefill_chunk_tokens: int = 0   # >0: chunked prefill, one pass per tick
    greedy: bool = True
    sample_seed: int = 0            # rng seed for greedy=False sampling
    shadow_check: bool = False      # trace the page lifecycle and check it
                                    # every tick (analysis.sanitizer)
    device: str = "cuda"            # planes, weights and kernels
    # kernel-true decode on the card: replay the step as one captured CUDA
    # graph (False: run it eagerly, the reference under jax.disable_jit)
    capture_decode: bool = True
    # memory tiers and PE of the restore planner (H100 by default)
    fast_tier: MemoryTier = H100_HBM
    slow_tier: MemoryTier = H100_PINNED_HOST
    pe: PEModel = H100_SM


@dataclasses.dataclass
class EngineMetrics:
    ticks: int = 0
    tokens_emitted: int = 0
    prefills: int = 0
    prefill_skips: int = 0      # admissions served entirely from shared pages
    chunk_passes: int = 0       # chunked-prefill passes (subset of prefills)
    decode_steps: int = 0
    preemptions: int = 0        # slots swapped out for a more urgent arrival
    readmissions: int = 0       # preempted requests resumed mid-stream
    slo_violations: int = 0     # first tokens emitted after their deadline
    wall_time: float = 0.0

    @property
    def tokens_per_sec(self) -> float:
        if self.wall_time <= 0.0:
            return 0.0
        return self.tokens_emitted / self.wall_time


class PagedServingEngine:
    """Continuous batching over a paged, PUL-tiered KV cache."""

    def __init__(self, cfg: ModelConfig, params,
                 engine_cfg: PagedEngineConfig = PagedEngineConfig(),
                 metrics_hook: Optional[Callable[[Dict[str, Any]], None]] = None,
                 tracer: Optional[Tracer] = None):
        from repro_torch.serving.config import ServingConfig
        if isinstance(engine_cfg, ServingConfig):
            engine_cfg = engine_cfg.paged()
        self.device = resolve_device(engine_cfg.device)
        self.base_cfg = cfg
        self.model_cfg = dataclasses.replace(cfg, paged_kv=True)
        T.check_supported(self.model_cfg)
        self.cfg = engine_cfg
        self.metrics_hook = metrics_hook
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.model = Model(self.model_cfg, params)
        self.params = params

        B, S, P = engine_cfg.batch_slots, engine_cfg.max_seq, engine_cfg.page_tokens
        if S % P:
            raise ValueError(f"max_seq ({S}) must be a multiple of "
                             f"page_tokens ({P})")
        if max(engine_cfg.prefill_buckets) > S:
            raise ValueError("prefill bucket exceeds max_seq")
        if engine_cfg.prefill_chunk_tokens and (
                engine_cfg.prefill_chunk_tokens % P):
            raise ValueError(
                f"prefill_chunk_tokens ({engine_cfg.prefill_chunk_tokens}) "
                f"must be a multiple of page_tokens ({P}) so chunk "
                "boundaries are page-aligned")
        self.n_pages_per_slot = S // P

        self.layout = PackedKVLayout(self.model_cfg, B, S)
        hot = engine_cfg.hot_pages or (B * self.n_pages_per_slot + 2)
        gqa = cfg.num_heads // max(cfg.num_kv_heads, 1)
        pcfg = PageConfig(page_tokens=P, hot_frames=hot + 2,
                          fast_tier=engine_cfg.fast_tier,
                          slow_tier=engine_cfg.slow_tier, pe=engine_cfg.pe,
                          preload_distance=engine_cfg.preload_distance,
                          share_prefix_pages=engine_cfg.share_prefix_pages,
                          trace=engine_cfg.shadow_check)
        self.pool = KVPagePool(pcfg, layout=self.layout, gqa_group=gqa,
                               device=self.device, tracer=self.tracer)
        # shadow mode: an incremental checker consumes the pool's trace
        # every tick (O(new events)), naming the offending event at the
        # tick it happened
        self._shadow_checker = (LifecycleChecker() if engine_cfg.shadow_check
                                else None)
        self.scheduler = AdmissionScheduler(SchedulerConfig(
            prefill_buckets=engine_cfg.prefill_buckets,
            max_active_tokens=engine_cfg.max_active_tokens or B * S,
            page_tokens=P, policy=engine_cfg.policy, max_seq=S),
            tracer=self.tracer)
        # the planner's d*, clamped to the FIFO: the in-kernel preload
        # distance (K1-K4's page ring, K5's request ring)
        self.pul_distance = max(1, min(self.pool.distance,
                                       self.pool.cfg.fifo_depth))

        self.slot_req: List[Optional[Request]] = [None] * B
        self.slot_len = np.zeros((B,), np.int32)    # tokens cached per slot
        self.slot_pages: List[List[int]] = [[] for _ in range(B)]
        self.paused: List[bool] = [False] * B
        # the non-pageable cache leaves (recurrent state) only, zeroed; the
        # pageable ones live in the planes and idx in slot_len
        pageable = {e.keys for e in self.layout.entries}
        self.resident: Dict[str, Any] = {}
        for keys, (shape, dt) in _leaves(T.cache_specs(self.model_cfg, B, S)):
            if keys not in pageable and keys[-1] != "idx":
                _put(self.resident, keys, torch.zeros(shape, dtype=dt,
                                                      device=self.device))
        # first-token logits are replayed only where pages rebuild every
        # cache; recurrent state cannot be rebuilt from pages
        self._has_recurrent = bool(self.resident)
        self._paused_state: Dict[int, Dict[Tuple[str, ...], Any]] = {}
        self.metrics = EngineMetrics()
        self.requests: Dict[int, Request] = {}
        self._rng = np.random.default_rng(engine_cfg.sample_seed)
        # policy-preempted (swapped-out) requests: rid -> saved slot state
        self._swapped: Dict[int, Dict[str, Any]] = {}
        # in-flight chunked prefills: slot -> {"prompt", "filled"}
        self._chunk: Dict[int, Dict[str, Any]] = {}
        self._tick = 0
        # first-token logits per fully page-aligned shared prompt, keyed
        # (bucket, prompt tuple); bounded LRU
        self._prompt_logits: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        # the decode step's inputs: filled on the host, one copy a tick into
        # a fixed device buffer whose views the device half reads
        n = self.n_pages_per_slot
        self._step_host = np.zeros(B * (n + 5), np.int32)
        self._step_dev = torch.zeros(B * (n + 5), dtype=torch.int32,
                                     device=self.device)
        self._host_batch = self._step_views(self._step_host)
        self._batch = self._step_views(self._step_dev)
        # the page table kept across ticks (row i: the frames of
        # slot_pages[i], ZERO_FRAME after the last); a row in _stale_rows
        # is rewritten from its pages before the slot next decodes
        self._page_table = np.full((B, n), ZERO_FRAME, np.int32)
        self._stale_rows: Set[int] = set()
        self._captured: Optional[CapturedStep] = None
        self._step_timer: Optional[StepTimer] = None

    # ------------------------------------------------------------------ #
    def submit(self, req: Request):
        """Reject-at-submit anything that can NEVER be served."""
        cost = self.scheduler.request_cost(req)
        if cost > self.cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) = {cost} exceeds "
                f"max_seq ({self.cfg.max_seq}); it can never fit a slot")
        if self.scheduler.request_pages(req) > self.pool.capacity:
            raise ValueError(
                f"request {req.rid} needs {self.scheduler.request_pages(req)}"
                f" pages; hot tier holds {self.pool.capacity}")
        if cost > self.scheduler.cfg.max_active_tokens:
            raise ValueError(f"request {req.rid} exceeds the token budget")
        self.requests[req.rid] = req
        self.scheduler.submit(req, self._tick)
        if self.tracer.enabled:
            self.tracer.async_begin(
                "requests", f"req{req.rid}", req.rid, cat="request",
                prompt_tokens=len(req.prompt),
                max_new_tokens=req.max_new_tokens,
                priority=req.priority, ttft_deadline=req.ttft_deadline)

    # ------------------------------------------------------------------ #
    def _live_slots(self) -> List[int]:
        """Slots that decode this tick: occupied, not paused, and not still
        mid-chunked-prefill."""
        return [i for i, r in enumerate(self.slot_req)
                if r is not None and not self.paused[i]
                and i not in self._chunk]

    def _active_tokens(self) -> int:
        return sum(self.scheduler.request_cost(r)
                   for r in self.slot_req if r is not None)

    def _live_page_count(self) -> int:
        return sum(len(self.slot_pages[i])
                   for i, r in enumerate(self.slot_req) if r is not None)

    # ------------------------------------------------------------------ #
    # admission + per-slot prefill
    # ------------------------------------------------------------------ #
    def _run_admission(self) -> List[Admission]:
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        return self.scheduler.admit(
            free,
            active_tokens=self._active_tokens(),
            free_hot_frames=self.pool.capacity - self._live_page_count(),
            now=self._tick,
            total_hot_frames=self.pool.capacity)

    def _admit(self):
        self._place(self._run_admission())
        if self.scheduler.cfg.policy == "fcfs":
            return
        for _ in range(len(self.slot_req)):
            cand = self.scheduler.head()
            if cand is None:
                return
            victim = self._preemption_victim(cand)
            if victim is None:
                return
            if self.tracer.enabled:
                policy = self.scheduler.cfg.policy
                self.tracer.decision(
                    "preempt", rid=self.slot_req[victim].rid, slot=victim,
                    for_rid=cand.rid, policy=policy,
                    reason=("deadline-lookahead" if policy == "slo-edf"
                            else "priority"))
            self._preempt_to_queue(victim)
            self._place(self._run_admission())

    def _place(self, admissions: List[Admission]):
        """Route admissions: swapped-out requests resume from saved pages,
        long prompts start chunked prefill, fully-shared prompts skip
        compute, the rest batch into per-bucket prefill groups."""
        if self.tracer.enabled:
            for a in admissions:
                self.tracer.async_begin(
                    "slots", f"slot{a.slot}", a.request.rid, cat="slot",
                    slot=a.slot, rid=a.request.rid)
        by_bucket: Dict[int, List[Admission]] = {}
        for a in admissions:
            if a.request.rid in self._swapped:
                self._resume_swapped(a)
                continue
            if self._try_shared_prefill(a):
                continue
            chunk = self.cfg.prefill_chunk_tokens
            if chunk and len(a.request.prompt) > chunk:
                self._start_chunk(a)
                continue
            by_bucket.setdefault(a.bucket, []).append(a)
        for bucket, group in sorted(by_bucket.items()):
            self._prefill_group(bucket, group)

    # ------------------------------------------------------------------ #
    # policy-driven preemption (swap-out to the cold tier + requeue)
    # ------------------------------------------------------------------ #
    def _occupied_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req)
                if r is not None and not self.paused[i]]

    def _remaining_ticks(self, slot: int) -> int:
        r = self.slot_req[slot]
        rem = r.max_new_tokens - len(r.out_tokens)
        st = self._chunk.get(slot)
        if st is not None:
            chunk = self.cfg.prefill_chunk_tokens
            left = len(st["prompt"]) - st["filled"]
            rem += -(-left // chunk)
        return max(rem, 0)

    def _preemption_victim(self, cand: Request) -> Optional[int]:
        """priority: the lowest-priority running request below cand's
        (latest-admitted within a tie); slo-edf: only when cand's TTFT
        deadline would otherwise be missed, the running request with the
        latest pending deadline."""
        occupied = self._occupied_slots()
        if not occupied:
            return None
        policy = self.scheduler.cfg.policy
        if policy == "priority":
            victims = [i for i in occupied
                       if self.slot_req[i].priority < cand.priority]
            if not victims:
                return None
            return min(victims, key=lambda i: (self.slot_req[i].priority,
                                               -self.slot_req[i].admit_tick))
        if policy == "slo-edf":
            deadline = cand.deadline_tick()
            if deadline == float("inf"):
                return None
            if self._tick + min(self._remaining_ticks(i)
                                for i in occupied) <= deadline:
                return None
            victims = [i for i in occupied
                       if self.slot_req[i].deadline_tick() > deadline]
            if not victims:
                return None
            return max(victims,
                       key=lambda i: (self.slot_req[i].deadline_tick(),
                                      self.slot_req[i].admit_tick))
        return None

    def _preempt_to_queue(self, slot: int):
        """Swap a running request out: private pages spill to the cold tier,
        its recurrent state's rows and chunked-prefill progress are kept,
        and the request requeues."""
        req = self.slot_req[slot]
        state = {
            "pages": self.slot_pages[slot],
            "slot_len": int(self.slot_len[slot]),
            "nonpageable": self._nonpageable_rows(slot),
            "chunk": self._chunk.pop(slot, None),
        }
        self.pool.evict_pages([pid for pid in state["pages"]
                               if self.pool.pages[pid].refcount == 1])
        self._swapped[req.rid] = state
        self.slot_req[slot] = None
        self._set_pages(slot, [])
        self.slot_len[slot] = 0
        self.paused[slot] = False
        self.metrics.preemptions += 1
        self.scheduler.requeue(req, now=self._tick)
        if self.tracer.enabled:
            self.tracer.async_end("slots", f"slot{slot}", req.rid,
                                  cat="slot", preempted=True)

    def _resume_swapped(self, a: Admission):
        """Readmit a swapped-out request: its saved pages re-attach (still
        cold until the next decode step's planned restore) and its
        recurrent state's rows are written back."""
        state = self._swapped.pop(a.request.rid)
        req = a.request
        req.resuming = False
        slot = a.slot
        self.slot_req[slot] = req
        self._set_pages(slot, state["pages"])
        self.slot_len[slot] = state["slot_len"]
        self.paused[slot] = False
        if state["nonpageable"]:
            self._write_nonpageable_rows(slot, state["nonpageable"])
        if state["chunk"] is not None:
            self._chunk[slot] = state["chunk"]
        self.pool.note_deadline(state["pages"], req.deadline_tick())
        self.metrics.readmissions += 1
        if self.tracer.enabled:
            self.tracer.decision("resume", rid=req.rid, slot=slot,
                                 pages=len(state["pages"]))

    def _try_shared_prefill(self, a: Admission) -> bool:
        """Admit a request whose whole page-aligned prompt is already
        resident as shared pages: ref the pages and replay the cached
        first-token logits, with no prefill compute."""
        P = self.cfg.page_tokens
        prompt = a.request.prompt[-a.bucket:]
        n = len(prompt)
        if not self._replays_logits(n):
            return False
        key = (a.bucket, tuple(prompt))
        logits = self._prompt_logits.get(key)
        if logits is None:
            return False
        page_keys = [(a.bucket, tuple(prompt[:(j + 1) * P]))
                     for j in range(n // P)]
        if any(k not in self.pool.prefix_index for k in page_keys):
            return False
        pids = [self.pool.lookup_shared(k) for k in page_keys]
        self.pool.note_deadline(pids, a.request.deadline_tick())
        self.slot_req[a.slot] = a.request
        self._set_pages(a.slot, pids)
        self.slot_len[a.slot] = n
        self.paused[a.slot] = False
        self.metrics.prefill_skips += 1
        self._prompt_logits.move_to_end(key)
        self._emit_token(a.slot, logits)
        return True

    def _write_prompt_pages(self, slot: int, key_bucket: int,
                            prompt: List[int], lo: int, hi: int,
                            packed: torch.Tensor):
        """Allocate (or prefix-share) and fill the pages covering prompt
        tokens [lo, hi) of `slot`. `packed` is this slot's (S >= hi, F)
        packed KV rows; `lo` must be page-aligned. FULL pages are shareable
        under (key_bucket, prompt-prefix) keys. No page any slot holds is
        evicted to make room."""
        P = self.cfg.page_tokens
        req = self.slot_req[slot]
        pids = self.slot_pages[slot]
        if lo % P or lo // P != len(pids):
            raise ValueError(f"prompt pages of slot {slot} start at {lo}")
        for j in range(lo // P, -(-hi // P)):
            plo, phi = j * P, min((j + 1) * P, hi)
            if phi == (j + 1) * P:
                key = (key_bucket, tuple(prompt[:phi]))
                pid = self.pool.lookup_shared(key)
                if pid is None:
                    pid = self.pool.alloc(shared_key=key
                                          if self.cfg.share_prefix_pages
                                          else None,
                                          needed=self._held_pages)
                    self.pool.write_page(pid, packed[plo:phi], phi - plo)
            else:
                pid = self.pool.alloc(needed=self._held_pages)
                self.pool.write_page(pid, packed[plo:phi], phi - plo)
            self._add_page(slot, pid)
        self.pool.note_deadline(pids, req.deadline_tick())

    def _prefill(self, rows: List[List[int]], slots: List[int], bucket: int):
        """Prefill right-padded prompts (row r for slot slots[r]) at
        `bucket`; returns (fp32 numpy logits (n, V), packed KV rows
        (n, bucket, F)), in the order of `rows`.

        A dense model prefills the n rows alone: its rows are independent.
        An MoE model prefills the reference's batch, all B slots with each
        row at its slot and every other slot a padding row (token 0, length
        1), since capacity dispatch mixes tokens across the batch: the
        batch's token count sets each group's capacity C, and the padding
        rows' tokens use it up (``repro/serving/engine.py``,
        ``_prefill_group_inner`` and ``_chunk_pass``).

        Also returns the prefill's cache tree and, for each row of `rows`,
        its row in that tree (for the recurrent state)."""
        moe = self.model_cfg.num_experts > 0
        at = list(slots) if moe else list(range(len(rows)))
        n = self.cfg.batch_slots if moe else len(rows)
        toks = np.zeros((n, bucket), np.int64)
        lengths = np.ones((n,), np.int64)
        for r, prompt in zip(at, rows):
            toks[r, :len(prompt)] = prompt
            lengths[r] = len(prompt)
        logits, caches = self.model.prefill(
            torch.as_tensor(toks, device=self.device),
            torch.as_tensor(lengths, device=self.device), max_seq=bucket)
        self.metrics.prefills += 1
        packed = self.layout.pack(caches) if self.layout.features else None
        if moe:
            idx = torch.as_tensor(at, device=self.device)
            logits = logits[idx]
            packed = packed[idx] if packed is not None else None
        return logits.cpu().numpy(), packed, caches, at

    def _prefill_group(self, bucket: int, group: List[Admission]):
        with self.tracer.span("engine", f"prefill@{bucket}"):
            self._prefill_group_inner(bucket, group)

    def _prefill_group_inner(self, bucket: int, group: List[Admission]):
        prompts = [a.request.prompt[-bucket:] for a in group]
        for a in group:
            self.slot_req[a.slot] = a.request
        logits, packed, caches, at = self._prefill(
            prompts, [a.slot for a in group], bucket)
        for r, (a, prompt) in enumerate(zip(group, prompts)):
            slot, n = a.slot, len(prompt)
            self._set_pages(slot, [])
            if self.layout.features:
                self._write_prompt_pages(slot, bucket, prompt, 0, n,
                                         packed[r])
            self.slot_len[slot] = n
            self.paused[slot] = False
            self._merge_resident(caches, at[r], slot)
            if self._replays_logits(n):
                self._remember_prompt_logits((bucket, tuple(prompt)),
                                             logits[r])
            self._emit_token(slot, logits[r])

    def _replays_logits(self, n: int) -> bool:
        """Whether a prompt of n tokens lands whole in shared pages that an
        identical prompt can take with the cached first-token logits:
        sharing on, page-aligned, and nothing but pages to rebuild (no
        recurrent state)."""
        return (self.cfg.share_prefix_pages and not self._has_recurrent
                and n > 0 and n % self.cfg.page_tokens == 0)

    def _merge_resident(self, fresh: Dict[str, Any], row: int, slot: int):
        """Copy row `row` of every non-pageable leaf of a prefill's cache
        tree into `slot`'s row of ``resident``, in place."""
        for keys, leaf in _leaves(self.resident):
            _slot_row(keys, leaf, slot).copy_(
                _slot_row(keys, PackedKVLayout._get(fresh, keys), row))

    def _nonpageable_rows(self, slot: int) -> Dict[Tuple[str, ...], Any]:
        """A copy of `slot`'s rows of every non-pageable leaf: recurrent
        state advances every decode step, for paused slots too, and pages
        cannot rebuild it."""
        return {keys: _slot_row(keys, leaf, slot).clone()
                for keys, leaf in _leaves(self.resident)}

    def _write_nonpageable_rows(self, slot: int,
                                saved: Dict[Tuple[str, ...], Any]):
        for keys, leaf in _leaves(self.resident):
            _slot_row(keys, leaf, slot).copy_(saved[keys])

    def _merge_nonpageable(self, new: Optional[Dict[str, Any]]):
        """A decode step's new recurrent state copied over every row of
        ``resident`` (live or not, as the reference replaces the tree), in
        place."""
        for keys, leaf in _leaves(self.resident):
            leaf.copy_(PackedKVLayout._get(new, keys))

    def _remember_prompt_logits(self, key: tuple, logits: np.ndarray):
        self._prompt_logits[key] = logits
        if len(self._prompt_logits) > 512:
            self._prompt_logits.popitem(last=False)

    # ------------------------------------------------------------------ #
    # chunked prefill: one bounded pass per tick, interleaved with decode
    # ------------------------------------------------------------------ #
    def _start_chunk(self, a: Admission):
        self.slot_req[a.slot] = a.request
        self._set_pages(a.slot, [])
        self.slot_len[a.slot] = 0
        self.paused[a.slot] = False
        self._chunk[a.slot] = {"prompt": a.request.prompt[-a.bucket:],
                               "filled": 0}

    def _advance_chunks(self):
        for slot in sorted(self._chunk):
            with self.tracer.span("engine", f"chunk-pass@{slot}"):
                self._chunk_pass(slot)

    def _chunk_pass(self, slot: int):
        """Extend the slot's prefix by up to `prefill_chunk_tokens` tokens
        (prefill of the smallest bucket holding the prefix so far; causal
        attention makes the rows identical to a monolithic prefill) and bank
        the new pages; the final pass emits the first token."""
        st = self._chunk[slot]
        req = self.slot_req[slot]
        prompt, f = st["prompt"], st["filled"]
        n = len(prompt)
        hi = min(f + self.cfg.prefill_chunk_tokens, n)
        bucket = self.scheduler.pick_bucket(hi)
        logits, packed, caches, at = self._prefill([prompt[:hi]], [slot],
                                                   bucket)
        self.metrics.chunk_passes += 1
        if self.layout.features:
            self._write_prompt_pages(slot, req.bucket, prompt, f, hi,
                                     packed[0])
        st["filled"] = hi
        self.slot_len[slot] = hi
        if hi < n:
            return
        del self._chunk[slot]
        # the final pass's state: the prefill of the bucket holding the
        # whole prompt, as a monolithic prefill's
        self._merge_resident(caches, at[0], slot)
        if self._replays_logits(n):
            self._remember_prompt_logits((req.bucket, tuple(prompt)),
                                         logits[0])
        self._emit_token(slot, logits[0])

    # ------------------------------------------------------------------ #
    # decode
    # ------------------------------------------------------------------ #
    # the page table kept across ticks: one owner of its rows
    def _set_pages(self, slot: int, pids: List[int]):
        """Every change of a slot's page list but an appended page: the
        list replaced, the row cleared and marked for a rewrite."""
        self.slot_pages[slot] = pids
        self._page_table[slot] = ZERO_FRAME
        self._stale_rows.add(slot)

    def _add_page(self, slot: int, pid: int):
        """A page appended to a slot's list; a row that is current takes
        its frame (a new tail page), a marked one waits for its rewrite."""
        pages = self.slot_pages[slot]
        pages.append(pid)
        if slot not in self._stale_rows:
            self._page_table[slot, len(pages) - 1] = self.pool.pages[pid].frame

    def _refresh_rows(self, live: List[int]) -> int:
        """Bring the live slots' rows up to date once their pages are hot:
        rows that hold a page that moved tier since the last call are
        marked, then each marked live row is rewritten from its pages.
        Returns how many rows were rewritten."""
        moved = self.pool.take_moved()
        if moved:
            for i, pids in enumerate(self.slot_pages):
                if i not in self._stale_rows and not moved.isdisjoint(pids):
                    self._stale_rows.add(i)
        rebuild = [i for i in live if i in self._stale_rows]
        pages = self.pool.pages
        for i in rebuild:
            frames = [pages[pid].frame for pid in self.slot_pages[i]]
            if None in frames:
                raise RuntimeError(f"slot {i} reads a cold page")
            row = self._page_table[i]
            row[:len(frames)] = frames
            row[len(frames):] = ZERO_FRAME
            self._stale_rows.discard(i)
        return len(rebuild)

    def _held_pages(self) -> Set[int]:
        """Every page some slot holds (a prefill's working set)."""
        return {pid for pages in self.slot_pages for pid in pages}

    def _ensure_tail_pages(self, live: List[int],
                           working: Callable[[], Set[int]]):
        """Every live slot needs a writable page for the incoming token;
        the step's working set (`working()`, built only when a page has to
        be evicted to make room) is never evicted."""
        P = self.cfg.page_tokens
        for i in live:
            pos = int(self.slot_len[i])
            if pos // P == len(self.slot_pages[i]):
                pid = self.pool.alloc(needed=working)
                self.pool.note_deadline([pid],
                                        self.slot_req[i].deadline_tick())
                self._add_page(i, pid)

    def _step_views(self, buf):
        """The step buffer's fields, views of `buf`: page_table (B, n_pages)
        first (16-byte aligned for the kernels), then lengths, frames,
        offsets, pos0 (B,) and tokens (B, 1)."""
        B, n = self.cfg.batch_slots, self.n_pages_per_slot
        views = {"page_table": buf[:B * n].reshape(B, n)}
        for i, key in enumerate(("lengths", "frames", "offsets", "pos0",
                                 "tokens")):
            views[key] = buf[B * (n + i):B * (n + i + 1)]
        views["tokens"] = views["tokens"].reshape(B, 1)
        return views

    def step_inputs(self) -> List[torch.Tensor]:
        """What the decode step's device half reads: the weights, the
        planes, the recurrent state and the step buffer (whose addresses a
        captured step keeps)."""
        return [t for _, t in flatten(self.params)] + [
            *self._updated().values(), self._step_dev]

    def _updated(self) -> Dict[str, torch.Tensor]:
        """The buffers the kernel-true step updates in place, by name: the
        planes, and the recurrent state ("resident/..." leaves)."""
        return {**self.pool.planes,
                **{"/".join(("resident", *keys)): leaf
                   for keys, leaf in _leaves(self.resident)}}

    def _device_step(self):
        """The kernel-true decode step's device half: (logits (B, V), the
        token's packed (B, F) rows for the per-layer path to commit, or None
        on the sweep, whose kernels commit in place). The recurrent state's
        successor is copied into ``resident`` here, in place."""
        if self.cfg.sweep_decode:
            logits, new = self.model.paged_decode_step(
                self._batch, caches=self.resident or None,
                planes=self.pool.planes, pul_distance=self.pul_distance)
            self._merge_nonpageable(new)
            return logits, None
        caches = self.layout.page_view_tree(self.pool.planes)
        for keys, leaf in _leaves(self.resident):
            _put(caches, keys, leaf)
        logits, new = self.model.paged_decode_step(
            self._batch, caches=caches, pul_distance=self.pul_distance)
        self._merge_nonpageable(new)
        return logits, self.layout.token_rows(new)

    def _fill_step(self, live: List[int]):
        """The host half: the step buffer filled for the `live` slots (the
        TRASH sink and ZERO_FRAME pages at length 0 for every other slot)
        and copied to the device. Returns the commit (frames, offsets).
        The live rows of the page table are copied from the kept table;
        with the pool's trace on they are read page by page
        (``pool.frames_of``) and must equal the kept rows."""
        P = self.cfg.page_tokens
        h = self._host_batch
        h["page_table"].fill(ZERO_FRAME)
        h["frames"].fill(TRASH_FRAME)
        for key in ("lengths", "offsets", "tokens", "pos0"):
            h[key].fill(0)
        if live:
            rows = np.asarray(live)
            pos = self.slot_len[rows]
            h["tokens"][rows, 0] = [self.slot_req[i].out_tokens[-1]
                                    for i in live]
            h["pos0"][rows] = h["lengths"][rows] = pos
            # without pageable KV there are no pages to read or commit
            if self.layout.features:
                h["frames"][rows] = self._page_table[rows, pos // P]
                h["offsets"][rows] = pos % P
                h["page_table"][rows] = self._page_table[rows]
                if self.pool.trace is not None:
                    self._read_rows_by_page(live)
        self._step_dev.copy_(torch.from_numpy(self._step_host))
        return h["frames"].copy(), h["offsets"].copy()

    def _read_rows_by_page(self, live: List[int]):
        """The traced read of the live rows, page by page as the
        reference reads them (a READ event each), held to the kept rows."""
        for i in live:
            pids = self.slot_pages[i]
            frames = self.pool.frames_of(pids)
            if not np.array_equal(frames, self._page_table[i, :len(pids)]):
                raise RuntimeError(
                    f"slot {i}'s kept page-table row {self._page_table[i]} "
                    f"is not its pages' frames {frames}")

    def _ensure_captured(self):
        """On the card, the step timer where the tracer records, then the
        device half captured at the engine's first decode step, over dummy
        inputs that commit nothing (every slot writes to TRASH_FRAME); the
        warm-up's step of the recurrent state is taken back."""
        if self.device.type != "cuda":
            return
        if self._step_timer is None and self.tracer.enabled:
            self._step_timer = StepTimer(self.tracer.now_us, self.device)
        if self._captured is not None or not self.cfg.capture_decode:
            return
        self._fill_step([])
        state = [leaf.clone() for _, leaf in _leaves(self.resident)]
        self._captured = CapturedStep(
            self._device_step, inputs=self.step_inputs(),
            planes=self._updated(),
            what="sweep" if self.cfg.sweep_decode else "per-layer",
            timer=self._step_timer)
        for (_, leaf), saved in zip(_leaves(self.resident), state):
            leaf.copy_(saved)

    def _run_device_step(self):
        """The device half: replayed from its CUDA graph when captured, else
        run eagerly (between the step timer's events, where there is one:
        on the eager path its span holds the launches' gaps too)."""
        if self._captured is not None:
            return self._captured.replay(self._updated())
        timer = self._step_timer
        if timer is None:
            return self._device_step()
        timer.begin()
        out = self._device_step()
        timer.end()
        return out

    def _note_device_step(self):
        """The step's device time, once its logits are on the host: a
        ``device/decode_step`` span on the tracer's clock and a
        ``gauges/device_step_ms`` counter; when the timer sets a new
        anchor, the old one's drift (``gauges/device_clock_drift_us``)."""
        ts, dur = self._step_timer.span_us()
        tr = self.tracer
        tr.complete("device", "decode_step", ts=ts, dur=dur)
        tr.counter("gauges", "device_step_ms", dur / 1e3)
        drift = self._step_timer.reanchor_if_due()
        if drift is not None:
            tr.counter("gauges", "device_clock_drift_us", drift)

    def _decode_step(self):
        live = self._live_slots()
        if not live:
            return
        tr = self.tracer
        pool = self.pool
        with tr.span("engine", "decode_pages"):
            working = lambda: {pid for i in live for pid in self.slot_pages[i]}
            self._ensure_tail_pages(live, working)
            traced = pool.trace is not None
            # traced: every page touched (and, in _fill_step, read) one by
            # one, as in the reference
            faults = (pool.ensure_hot(sorted(working())) if traced
                      else pool.restore_cold(working))
            rebuilt = self._refresh_rows(live)
            if not traced:
                rows = self._page_table[live]
                pool.touch_frames(rows)
                if self.layout.features:
                    pool.note_reads(rows)
        if tr.enabled:
            tr.counter("gauges", "page_rows_rebuilt", rebuilt)
        # with no pageable KV the kernel-true paths have nothing to read:
        # the dense decode over the recurrent state, as in the reference
        kernel_true = self.cfg.use_paged_kernel and self.layout.features > 0
        with tr.span("engine", "decode_fill"):
            if kernel_true:
                self._ensure_captured()
            frames, offs = self._fill_step(live)
        with tr.span("engine", "decode_launch"):
            if not kernel_true:
                # assembly: dense decode over pages gathered into a fresh
                # tree beside the recurrent state, the step's new rows
                # written back into the tail pages and its new state into
                # resident
                tree = (self._assemble(self._batch["page_table"])
                        if self.layout.features else self.resident)
                logits, new = self.model.decode_step(self._batch, tree)
                if self.layout.features:
                    rows = self.layout.pack_rows(
                        new, torch.tensor(self.slot_len, device=self.device))
                    self.pool.write_rows(frames, offs, rows)
                self._merge_nonpageable(new)
            elif self.cfg.sweep_decode:
                # account + trace the fused commit BEFORE the launch
                self.pool.note_fused_commit(frames, offs)
                logits, _ = self._run_device_step()
            else:
                logits, rows = self._run_device_step()
                self.pool.write_rows(frames, offs, rows)
        self.metrics.decode_steps += 1

        with tr.span("engine", "decode_wait"):
            logits = self._logits_to_host(logits)
            if self._step_timer is not None:
                self._note_device_step()
        with tr.span("engine", "decode_emit"):
            for i in live:
                self.slot_len[i] += 1
                self._emit_token(i, logits[i])
        return faults

    def _logits_to_host(self, logits: torch.Tensor) -> np.ndarray:
        """A decode step's (B, V) fp32 logits on the host: on the card
        through pinned memory (PyTorch's caching host allocator), which the
        copy fills at the link's rate where a pageable copy does not."""
        if self.device.type != "cuda":
            return logits.numpy()
        host = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
        host.copy_(logits, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return host.numpy()

    def _set_idx(self, tree: Dict[str, Any], idx: np.ndarray):
        """Every block's cache idx leaf set to the per-slot fill levels
        `idx` ((L, B) for each pattern entry, (B,) for a dense layer)."""
        vec = torch.tensor(idx, dtype=torch.int32, device=self.device)
        for e in self.layout.entries:
            node = PackedKVLayout._get(tree, e.keys[:-1])
            node["idx"] = vec.expand(e.layers, -1) if e.grouped else vec
        return tree

    def _assemble(self, page_table: torch.Tensor) -> Dict[str, Any]:
        """The assembly path's decode cache tree: the packed store gathered
        by page table (ZERO_FRAME past each slot's pages) into a dense
        (B, S, F) view — through K5 with ``use_pallas_gather`` — unpacked
        into cache leaves beside ``resident``'s recurrent state, with idx
        the slots' fill levels. The store is a copy of the planes, so the
        dense decode's in-place row writes land in this step's tree and
        never in the planes."""
        store = self.pool.packed_store()
        if self.cfg.use_pallas_gather:
            packed = pul_page_gather(
                store, page_table, cfg=PULConfig(distance=self.pul_distance))
        else:
            packed = store[page_table.long()].reshape(
                self.cfg.batch_slots, self.cfg.max_seq, -1)
        return self._set_idx(self.layout.unpack_into(self.resident, packed),
                             self.slot_len)

    def _emit_token(self, slot: int, logits: np.ndarray):
        r = self.slot_req[slot]
        if self.cfg.greedy:
            nxt = int(np.argmax(logits))
        else:
            z = logits.astype(np.float64) - logits.max()
            p = np.exp(z)
            nxt = int(self._rng.choice(p.shape[-1], p=p / p.sum()))
        r.out_tokens.append(nxt)
        self.metrics.tokens_emitted += 1
        if r.first_token_tick < 0:
            r.first_token_tick = self._tick
            if r.ttft_deadline >= 0 and r.ttft > r.ttft_deadline:
                self.metrics.slo_violations += 1
        out_of_room = int(self.slot_len[slot]) + 1 >= self.cfg.max_seq
        if len(r.out_tokens) >= r.max_new_tokens or out_of_room:
            self._finish(slot)

    def _finish(self, slot: int):
        req = self.slot_req[slot]
        req.done = True
        if self.tracer.enabled:
            self.tracer.async_end("requests", f"req{req.rid}", req.rid,
                                  cat="request", tokens=len(req.out_tokens))
            self.tracer.async_end("slots", f"slot{slot}", req.rid,
                                  cat="slot")
        for pid in self.slot_pages[slot]:
            self.pool.unref(pid)
        self._set_pages(slot, [])
        self.slot_req[slot] = None
        self.slot_len[slot] = 0
        self.paused[slot] = False
        self._paused_state.pop(slot, None)

    # ------------------------------------------------------------------ #
    # preemption (swap-out: pages spill to the cold tier)
    # ------------------------------------------------------------------ #
    def preempt(self, slot: int):
        """Pause a slot and evict its private pages to the cold tier.
        Shared prefix pages stay hot while other requests reference them.
        The recurrent state's rows are snapshotted: a paused slot still
        rides through the batched decode step with token 0, which advances
        its state."""
        if self.slot_req[slot] is None:
            raise ValueError(f"slot {slot} is empty")
        if self.tracer.enabled:
            self.tracer.instant("engine", "pause", slot=slot,
                                rid=self.slot_req[slot].rid)
        self.paused[slot] = True
        self._paused_state[slot] = self._nonpageable_rows(slot)
        self.pool.evict_pages(
            [pid for pid in self.slot_pages[slot]
             if self.pool.pages[pid].refcount == 1])

    def resume(self, slot: int):
        """Un-pause; the next decode step's ensure_hot restores the pages
        through the planned preload path (counted as page faults), and the
        snapshotted recurrent state is written back."""
        if self.slot_req[slot] is None:
            raise ValueError(f"slot {slot} is empty")
        if self.tracer.enabled:
            self.tracer.instant("engine", "unpause", slot=slot,
                                rid=self.slot_req[slot].rid)
        self.paused[slot] = False
        saved = self._paused_state.pop(slot, None)
        if saved:
            self._write_nonpageable_rows(slot, saved)

    # ------------------------------------------------------------------ #
    def step(self):
        t0 = time.perf_counter()
        tr = self.tracer
        tr.set_tick(self._tick)
        with tr.span("engine", "tick"):
            with tr.span("engine", "admit"):
                self._admit()
            self._advance_chunks()
            with tr.span("engine", "decode"):
                faults = self._decode_step() or 0
        self._tick += 1
        self.metrics.ticks = self._tick
        self.metrics.wall_time += time.perf_counter() - t0
        if tr.enabled:
            tr.counter("gauges", "live_slots", len(self._live_slots()))
            tr.counter("gauges", "queued", len(self.scheduler))
            tr.counter("gauges", "hot_pages_in_use", self.pool.hot_in_use())
            tr.counter("gauges", "page_faults_step", faults)
        if self._shadow_checker is not None:
            self._run_shadow_check()
        if self.metrics_hook:
            # snapshot() runs outside the guard: an invariant violation must
            # crash; only the user-supplied observer is sandboxed
            snap = self.snapshot(page_faults_step=faults)
            try:
                self.metrics_hook(snap)
            except Exception as e:
                warnings.warn(
                    f"metrics_hook raised {e!r}; disabling the hook for the "
                    "rest of this engine's life", RuntimeWarning,
                    stacklevel=2)
                self.metrics_hook = None

    def _run_shadow_check(self):
        """Feed the tick's new trace events through the lifecycle checker;
        raise at the first violation (with event provenance)."""
        fresh = self._shadow_checker.feed_log(self.pool.trace)
        if fresh:
            raise LifecycleViolationError(fresh)

    def snapshot(self, **extra) -> Dict[str, Any]:
        pm = self.pool.metrics
        pm.validate()
        lat = self.scheduler.queue_latencies()
        snap = {
            "tick": self._tick,
            "policy": self.scheduler.cfg.policy,
            "tokens_emitted": self.metrics.tokens_emitted,
            "tokens_per_sec": self.metrics.tokens_per_sec,
            "prefills": self.metrics.prefills,
            "prefill_skips": self.metrics.prefill_skips,
            "chunk_passes": self.metrics.chunk_passes,
            "preemptions": self.metrics.preemptions,
            "readmissions": self.metrics.readmissions,
            "slo_violations": self.metrics.slo_violations,
            "rejected": self.scheduler.rejected,
            "swapped_out": len(self._swapped),
            "live_slots": len(self._live_slots()),
            "queued": len(self.scheduler),
            "page_faults": pm.page_faults,
            "evictions": pm.evictions,
            "shared_page_hits": pm.shared_hits,
            "pages_allocated": pm.pages_allocated,
            "hot_pages_in_use": self.pool.hot_in_use(),
            "preload_distance": self.pool.distance,
            "modeled_restore_latency_hidden": pm.modeled_latency_hidden,
            "mean_queue_latency": mean(lat),
        }
        snap.update(extra)
        return snap

    def economics(self) -> Dict[str, Any]:
        """Bytes moved per token emitted per tier, and prefetch accuracy /
        timeliness / coverage of the planned d* restores."""
        return cache_economics(page_bytes=self.pool.page_bytes,
                               tokens_emitted=self.metrics.tokens_emitted,
                               pool_metrics=self.pool.metrics)

    def metrics_registry(self) -> MetricsRegistry:
        reg = MetricsRegistry()
        policy = self.scheduler.cfg.policy
        for k, v in self.snapshot().items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            reg.set(f"pul_engine_{k}", v, policy=policy)
        economics_into_registry(reg, self.economics(), policy=policy)
        return reg

    def pending(self) -> bool:
        """Whether a request is still queued or in a slot."""
        return bool(len(self.scheduler)
                    or any(r is not None for r in self.slot_req))

    def run(self, max_ticks: int = 1000) -> Dict[int, List[int]]:
        """Drive steps until every submitted request completes (or the tick
        cap); returns {rid: generated tokens} for ALL submitted requests."""
        ticks = 0
        while self.pending() and ticks < max_ticks:
            self.step()
            ticks += 1
        return _drain_results(self.requests)
