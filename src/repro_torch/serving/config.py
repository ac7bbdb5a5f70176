"""One serving configuration to rule the layers (port of
``repro/serving/config.py``).

The port serves through ``PagedServingEngine`` only; the dense reference
engine (``dense()``) and the assembly-path knob ``use_pallas_gather`` are not
ported, and asking for them raises ``NotImplementedError``. The port adds
``device`` (default ``"cuda"``) and defaults ``use_paged_kernel`` to True.

:class:`ServingConfig` is ONE documented facade holding the union of the
serving knobs, with projections onto each layer's config (:meth:`paged`,
:meth:`scheduler`, :meth:`pages`) and a single argparse adapter
(:meth:`add_flags` / :meth:`from_flags`) used by ``repro_torch.launch.serve``.
``PagedServingEngine`` accepts a ``ServingConfig`` directly.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

# Default prefill bucket ladder; buckets above max_seq are dropped by
# from_flags/paged (the scheduler requires every bucket <= max_seq).
_BUCKET_LADDER = (16, 32, 64, 128)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Union of every serving knob, documented once.

    Capacity / shape:
      batch_slots: concurrent decode slots (the continuous batch width).
      max_seq: per-slot token capacity (prompt + generated); paged mode
        requires it to be a multiple of ``page_tokens``.

    Sampling:
      greedy: argmax decoding (True) or temperature-1 sampling (False).
      sample_seed: rng seed for ``greedy=False`` — shared by both engines
        so sampled runs stay differential-testable.

    Dense reference engine only:
      prefill_bucket: the single left-padded prefill width.

    Page store (paged engine):
      page_tokens: tokens per KV page.
      hot_pages: fast-tier frames (0 = size for every live slot resident).
      preload_distance: PUL preload distance for page restores
        (None = the planner's d*).
      share_prefix_pages: share page-aligned prompt prefixes across
        requests (and reuse their cached first-token logits).

    Decode path (paged engine):
      use_pallas_gather: route dense assembly through the PUL page gather.
      use_paged_kernel: kernel-true decode straight over page frames.
      sweep_decode: with the kernel, run ALL layers as one sweep over the
        per-layer planes with the token commit fused into the kernel
        epilogue (False = per-layer launches + eager scatter).

    Admission (paged engine):
      prefill_buckets: ascending compiled prefill widths.
      max_active_tokens: token budget across live slots (0 = slots cap).
      policy: "fcfs" | "priority" | "slo-edf" (the latter two preempt).
      prefill_chunk_tokens: page-aligned chunked prefill threshold
        (0 = monolithic prefill at admission).

    Debug:
      shadow_check: trace the page lifecycle and replay it through the
        sanitizer every tick (not ported yet: raises).

    Device:
      device: where the planes, weights and kernels live ("cuda" default;
        "cpu" runs the kernels' plain versions, for the tests).
    """

    batch_slots: int = 4
    max_seq: int = 256
    greedy: bool = True
    sample_seed: int = 0
    prefill_bucket: int = 64
    page_tokens: int = 16
    hot_pages: int = 0
    preload_distance: Optional[int] = None
    share_prefix_pages: bool = True
    use_pallas_gather: bool = False
    use_paged_kernel: bool = True
    sweep_decode: bool = True
    prefill_buckets: Tuple[int, ...] = (16, 32, 64)
    max_active_tokens: int = 0
    policy: str = "fcfs"
    prefill_chunk_tokens: int = 0
    shadow_check: bool = False
    device: str = "cuda"

    # ------------------------------------------------------------------ #
    # projections onto the per-layer configs
    # ------------------------------------------------------------------ #
    def dense(self):
        """The dense reference engine is not ported."""
        raise NotImplementedError(
            "the dense ServingEngine is not ported yet (ROADMAP)")

    def paged(self):
        """Project onto the paged engine's PagedEngineConfig."""
        from repro_torch.serving.engine import PagedEngineConfig
        buckets = tuple(b for b in self.prefill_buckets if b <= self.max_seq)
        return PagedEngineConfig(
            batch_slots=self.batch_slots, max_seq=self.max_seq,
            page_tokens=self.page_tokens, hot_pages=self.hot_pages,
            prefill_buckets=buckets or (self.max_seq,),
            max_active_tokens=self.max_active_tokens,
            preload_distance=self.preload_distance,
            share_prefix_pages=self.share_prefix_pages,
            use_pallas_gather=self.use_pallas_gather,
            use_paged_kernel=self.use_paged_kernel,
            sweep_decode=self.sweep_decode,
            policy=self.policy,
            prefill_chunk_tokens=self.prefill_chunk_tokens,
            greedy=self.greedy, sample_seed=self.sample_seed,
            shadow_check=self.shadow_check, device=self.device)

    def scheduler(self):
        """Project onto the admission scheduler's SchedulerConfig (the
        same derivation PagedServingEngine applies internally)."""
        from repro_torch.serving.scheduler import SchedulerConfig
        p = self.paged()
        return SchedulerConfig(
            prefill_buckets=p.prefill_buckets,
            max_active_tokens=(p.max_active_tokens
                               or p.batch_slots * p.max_seq),
            page_tokens=p.page_tokens, policy=p.policy, max_seq=p.max_seq)

    def pages(self):
        """Project onto the page pool's PageConfig (hot-frame sizing as
        PagedServingEngine derives it, reserved frames included)."""
        from repro_torch.serving.kv_pages import PageConfig
        slot_pages = self.max_seq // self.page_tokens
        hot = self.hot_pages or (self.batch_slots * slot_pages + 2)
        return PageConfig(
            page_tokens=self.page_tokens, hot_frames=hot + 2,
            preload_distance=self.preload_distance,
            share_prefix_pages=self.share_prefix_pages,
            trace=self.shadow_check)

    # ------------------------------------------------------------------ #
    # the one flag surface
    # ------------------------------------------------------------------ #
    @staticmethod
    def add_flags(ap) -> None:
        """Register the serving knobs on an argparse parser (the flag
        names ``repro.launch.serve`` has always exposed)."""
        ap.add_argument("--slots", type=int, default=4)
        ap.add_argument("--max-seq", type=int, default=128)
        ap.add_argument("--page-tokens", type=int, default=16)
        ap.add_argument("--hot-pages", type=int, default=0)
        ap.add_argument("--distance", type=int, default=0,
                        help="page-restore preload distance (0 = planner d*)")
        ap.add_argument("--max-active-tokens", type=int, default=0)
        ap.add_argument("--no-prefix-sharing", action="store_true")
        ap.add_argument("--paged-kernel", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="kernel-true decode: attention streams straight "
                             "over page frames (the port's only decode path)")
        ap.add_argument("--no-sweep", action="store_true",
                        help="with --paged-kernel: per-layer kernel launches "
                             "+ eager row scatter instead of the fused "
                             "single-sweep decode")
        ap.add_argument("--policy", default="fcfs",
                        choices=("fcfs", "priority", "slo-edf"),
                        help="admission policy; priority and slo-edf preempt "
                             "running requests (swap-out to the cold tier)")
        ap.add_argument("--prefill-chunk", type=int, default=0,
                        help="chunked prefill: page-aligned tokens per tick "
                             "for prompts longer than this (0 = monolithic)")
        ap.add_argument("--device", default="cuda",
                        help="torch device (cuda by default; cpu runs the "
                             "kernels' plain versions)")

    @classmethod
    def from_flags(cls, args) -> "ServingConfig":
        """Build from a parsed argparse namespace (see :meth:`add_flags`).

        Unknown knobs keep their dataclass defaults, so a launcher that
        registers only a subset of the flags still gets a full config."""
        get = lambda name, default: getattr(args, name, default)
        max_seq = get("max_seq", 128)
        return cls(
            batch_slots=get("slots", 4),
            max_seq=max_seq,
            prefill_bucket=min(64, max_seq // 2),
            page_tokens=get("page_tokens", 16),
            hot_pages=get("hot_pages", 0),
            preload_distance=get("distance", 0) or None,
            max_active_tokens=get("max_active_tokens", 0),
            share_prefix_pages=not get("no_prefix_sharing", False),
            use_paged_kernel=get("paged_kernel", True),
            sweep_decode=not get("no_sweep", False),
            policy=get("policy", "fcfs"),
            prefill_chunk_tokens=get("prefill_chunk", 0),
            prefill_buckets=tuple(b for b in _BUCKET_LADDER
                                  if b <= max_seq) or (max_seq,),
            device=get("device", "cuda"),
        )
