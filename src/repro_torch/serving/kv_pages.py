"""Paged KV cache managed by the PUL engine (port of
``repro/serving/kv_pages.py``).

KV state is split into fixed-size *pages* of ``page_tokens`` tokens living in
a pool of physical frames across two tiers:

  * the **hot tier** — per-layer page *planes* on the device, the arrays the
    decode kernels read: attention leaves are ``(L, NF, K, P, hd)`` (layer,
    frame, kv head, page token, head dim) and MLA's compressed leaves
    ``(L, NF, P, feat)``, with L the leaf's layer extent (1 for an unscanned
    dense layer). A layer's frames are plane row ``layer`` (a view, no
    copy), and the sweep kernel walks all layers of a plane with a layer
    index;
  * the **cold tier** — host tensors (pinned when the planes are on a GPU)
    that evicted pages spill to, in the packed ``(P, F)`` row format (token t
    of a page is one row of every layer's K and V), so UNLOAD/PRELOAD byte
    accounting and the DMA twin are layout-independent.

Eviction emits UNLOAD descriptors and restores emit PRELOAD descriptors;
restores are planned at the planner's d* and replayed on the DMA twin to
account how much restore latency the schedule hides.

A page packs every layer's K and V for a token range, so one page id covers
the whole model and a prefix page can be shared by every request with that
prompt prefix (refcounted; only full, immutable prompt pages are shared).

The reference's v1 packed-store surface (a single packed plane and its view
shims) is not ported: the port has only the v2 per-layer planes. The
assembly decode path materializes the packed ``(NF, P, F)`` store from them
(:meth:`KVPagePool.packed_store`) and gathers each slot's pages out of it.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analysis.events import EventKind, TraceLog
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dma import DMAEngine, KVPageWorkload, run_kv_page_workload
from repro_torch.core.planner import kv_page_flops, plan_kv_page_stream
from repro_torch.core.pul import (
    CP_ASYNC_BYTES,
    H100_HBM,
    H100_PINNED_HOST,
    H100_SM,
    Direction,
    MemoryTier,
    PEModel,
    TransferRequest,
)
from repro_torch.obs.tracer import NULL_TRACER

# kv-bearing cache leaves (pageable when the seq axis matches max_seq):
# standard attention and MLA's compressed cache
_KV_LEAF_KEYS = ("k", "v", "c_kv", "k_rope")

#: Version of the KV store-layout protocol (the reference's v2 planes).
KV_LAYOUT_VERSION = 2


@dataclasses.dataclass(frozen=True)
class _LeafEntry:
    keys: Tuple[str, ...]       # dict path into the cache tree
    shape: Tuple[int, ...]      # full leaf shape
    grouped: bool               # True: (L, B, S, feat...); False: (B, S, feat...)
    nfeat: int                  # packed per-token features of this leaf
    offset: int                 # column offset in the packed row

    @property
    def plane_key(self) -> str:
        """Stable string id of this entry's store plane ("groups/0:global/k")."""
        return "/".join(self.keys)

    @property
    def feat(self) -> Tuple[int, ...]:
        """Per-token feature dims: (K, hd) for attention, (f,) for MLA."""
        return self.shape[3:] if self.grouped else self.shape[2:]

    @property
    def layers(self) -> int:
        """Leading layer extent of this entry's plane (1 when unscanned)."""
        return self.shape[0] if self.grouped else 1


class PackedKVLayout:
    """Mapping between a model's cache tree and its paged KV store (v2).

    Each pattern entry's pageable leaves are stacked over layers,
    ``(L, B, S, feat...)`` ("grouped"); an unscanned dense layer's are
    ``(B, S, feat...)``. Token t of slot b packs into row (b, t): the
    concatenation over pageable leaves (sorted by path) of that token's
    features across all layers — the cold tier's format, column for column
    the reference's.
    """

    layout_version = KV_LAYOUT_VERSION

    def __init__(self, cfg: ModelConfig, batch: int, max_seq: int):
        from repro_torch.models import transformer as T
        spec = T.cache_specs(cfg, batch, max_seq)
        self.cfg = cfg
        self.batch = batch
        self.max_seq = max_seq
        self.entries: List[_LeafEntry] = []
        off = 0
        for keys, (shape, _) in sorted(_leaves(spec)):
            grouped = keys[0] == "groups"
            seq_ax = 2 if grouped else 1
            if (keys[-1] not in _KV_LEAF_KEYS or len(shape) <= seq_ax
                    or shape[seq_ax] != max_seq):
                continue
            nfeat = int(np.prod(shape)) // (batch * max_seq)
            self.entries.append(_LeafEntry(keys, tuple(shape), grouped, nfeat,
                                           off))
            off += nfeat
        self.features = off

    # ------------------------------------------------------------------ #
    @staticmethod
    def _get(tree: Any, keys: Tuple[str, ...]) -> Any:
        node = tree
        for k in keys:
            node = node[k]
        return node

    def pack(self, tree: Any) -> torch.Tensor:
        """Cache tree -> (B, S, F) packed KV rows (S = the tree's seq size)."""
        outs = []
        for e in self.entries:
            leaf = self._get(tree, e.keys)
            if e.grouped:                   # (L, B, S, feat...) -> (B, S, L, ...)
                leaf = leaf.movedim(0, 2)
            outs.append(leaf.reshape(*leaf.shape[:2], -1))
        return torch.cat(outs, dim=-1)

    def unpack_into(self, tree: Any, packed: torch.Tensor) -> Any:
        """`tree` with every pageable leaf replaced from `packed` (B, S, F)."""
        B, S, _ = packed.shape
        new = _copy_tree(tree)
        for e in self.entries:
            cols = packed[..., e.offset:e.offset + e.nfeat]
            if e.grouped:
                leaf = cols.reshape(B, S, e.layers, *e.feat).movedim(2, 0)
            else:
                leaf = cols.reshape(B, S, *e.feat)
            node = new
            for k in e.keys[:-1]:
                node = node.setdefault(k, {})
            node[e.keys[-1]] = leaf.to(torch.bfloat16)
        return new

    def pack_rows(self, tree: Any, idx: torch.Tensor) -> torch.Tensor:
        """One packed row per slot: (B, F) at per-slot positions `idx` (B,)
        of a dense cache tree (the assembly decode's new-token rows)."""
        B = idx.shape[0]
        rows = torch.arange(B, device=idx.device)
        outs = []
        for e in self.entries:
            leaf = self._get(tree, e.keys)
            S = leaf.shape[2 if e.grouped else 1]
            i = idx.long().clamp(0, S - 1)
            if e.grouped:                   # (L, B, S, feat...) -> (B, S, L, ...)
                leaf = leaf.movedim(0, 2)
            outs.append(leaf[rows, i].reshape(B, -1))
        return torch.cat(outs, dim=-1)

    def token_rows(self, new_tree: Any) -> torch.Tensor:
        """A per-layer decode step's new-token leaves ((L, B, feat...) each,
        (B, feat...) for an unscanned layer) packed into (B, F) rows for
        :meth:`commit_token`."""
        outs = []
        for e in self.entries:
            leaf = self._get(new_tree, e.keys)
            if e.grouped:
                leaf = leaf.movedim(0, 1)
            outs.append(leaf.reshape(leaf.shape[0], -1))
        return torch.cat(outs, dim=-1)

    # ------------------------------------------------------------------ #
    # per-layer planes
    # ------------------------------------------------------------------ #
    def plane_shape(self, e: _LeafEntry, n_frames: int,
                    page_tokens: int) -> Tuple[int, ...]:
        feat = e.feat
        if len(feat) == 2:                  # attention: (L, NF, K, P, hd)
            return (e.layers, n_frames, feat[0], page_tokens, feat[1])
        return (e.layers, n_frames, page_tokens, *feat)   # MLA: (L, NF, P, f)

    def init_planes(self, n_frames: int, page_tokens: int, dtype,
                    device) -> Dict[str, torch.Tensor]:
        """Zeroed per-layer page planes for `n_frames` physical frames."""
        return {e.plane_key: torch.zeros(
                    self.plane_shape(e, n_frames, page_tokens), dtype=dtype,
                    device=device)
                for e in self.entries}

    def layer_view(self, planes: Dict[str, torch.Tensor],
                   layer: int) -> Dict[str, torch.Tensor]:
        """One layer's page frames per plane — a view: (NF, K, P, hd) for
        attention, (NF, P, f) for MLA. Unscanned (L == 1) entries ignore
        `layer`."""
        return {e.plane_key: planes[e.plane_key][layer if e.layers > 1 else 0]
                for e in self.entries}

    def page_view_tree(self, planes: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """A cache tree whose pageable leaves ARE the planes (not copies):
        what the per-layer decode path addresses, layer by layer. Grouped
        leaves keep their leading layer axis; unscanned leaves drop their
        singleton one."""
        tree: Dict[str, Any] = {}
        for e in self.entries:
            node = tree
            for k in e.keys[:-1]:
                node = node.setdefault(k, {})
            plane = planes[e.plane_key]
            node[e.keys[-1]] = plane if e.grouped else plane[0]
        return tree

    def commit_token(self, planes: Dict[str, torch.Tensor], rows: torch.Tensor,
                     frames: torch.Tensor, offsets: torch.Tensor) -> None:
        """Eager commit, in place: scatter one packed (F,) row per slot into
        its (frame, offset) page position across every plane. The fused
        equivalent runs in the sweep kernel's epilogue."""
        B = rows.shape[0]
        for e in self.entries:
            plane = planes[e.plane_key]
            vals = rows[:, e.offset:e.offset + e.nfeat].reshape(
                B, e.layers, *e.feat).to(plane.dtype)          # (B, L, feat...)
            if len(e.feat) == 2:
                # advanced indices (frames @ axis 1, offsets @ axis 3) split
                # by a slice: the broadcast B axis leads the indexed view
                plane[:, frames, :, offsets, :] = vals
            else:
                # adjacent advanced indices keep their place: (L, B, f)
                plane[:, frames, offsets, :] = vals.movedim(0, 1)

    def pack_planes(self, planes: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The packed (NF, P, F) store materialized from the planes — a
        copy, which only the assembly decode path pays: each plane is
        transposed into its column range in one pass."""
        e0 = self.entries[0]
        plane = planes[e0.plane_key]
        NF = plane.shape[1]
        P = plane.shape[3] if len(e0.feat) == 2 else plane.shape[2]
        out = torch.empty((NF, P, self.features), dtype=plane.dtype,
                          device=plane.device)
        for e in self.entries:
            plane = planes[e.plane_key]
            cols = out[..., e.offset:e.offset + e.nfeat]
            if len(e.feat) == 2:            # (L,NF,K,P,hd) -> (NF,P,L,K,hd)
                cols.view(NF, P, e.layers, *e.feat).copy_(
                    plane.permute(1, 3, 0, 2, 4))
            else:                           # (L,NF,P,f) -> (NF,P,L,f)
                cols.view(NF, P, e.layers, *e.feat).copy_(
                    plane.permute(1, 2, 0, 3))
        return out

    def read_frame_packed(self, planes: Dict[str, torch.Tensor],
                          frame: int) -> torch.Tensor:
        """One frame's packed (P, F) rows, on the planes' device."""
        cols = []
        for e in self.entries:
            sl = planes[e.plane_key][:, frame]
            if len(e.feat) == 2:            # (L, K, P, hd) -> (P, L, K, hd)
                sl = sl.permute(2, 0, 1, 3)
            else:                           # (L, P, f) -> (P, L, f)
                sl = sl.permute(1, 0, 2)
            cols.append(sl.reshape(sl.shape[0], -1))
        return torch.cat(cols, dim=-1)

    def write_frame_packed(self, planes: Dict[str, torch.Tensor], frame: int,
                           rows: torch.Tensor) -> None:
        """Fill one frame from packed (P, F) rows, in place."""
        P = rows.shape[0]
        for e in self.entries:
            plane = planes[e.plane_key]
            cols = rows[:, e.offset:e.offset + e.nfeat].to(
                device=plane.device, dtype=plane.dtype)
            vals = cols.reshape(P, e.layers, *e.feat)
            if len(e.feat) == 2:            # (P, L, K, hd) -> (L, K, P, hd)
                plane[:, frame] = vals.permute(1, 2, 0, 3)
            else:                           # (P, L, f) -> (L, P, f)
                plane[:, frame] = vals.permute(1, 0, 2)


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _copy_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (_copy_tree(v) if isinstance(v, dict) else v)
            for k, v in tree.items()}


# -------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PageConfig:
    """Knobs of the paged-KV pool (the serving face of PULConfig)."""

    page_tokens: int = 16
    hot_frames: int = 0                 # 0 -> sized to fit every live slot
    fast_tier: MemoryTier = H100_HBM
    slow_tier: MemoryTier = H100_PINNED_HOST
    pe: PEModel = H100_SM
    preload_distance: Optional[int] = None   # None -> planner d*
    fifo_depth: int = 64
    share_prefix_pages: bool = True
    trace: bool = False             # record page-lifecycle events (TraceLog)

    def __post_init__(self):
        if self.page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {self.page_tokens}")


@dataclasses.dataclass
class PoolMetrics:
    page_faults: int = 0        # pages restored from the cold tier
    evictions: int = 0          # pages written out to the cold tier
    shared_hits: int = 0        # prompt pages reused via prefix sharing
    pages_allocated: int = 0
    modeled_restore_time: float = 0.0   # DMA-twin time of all restore batches
    modeled_restore_stall: float = 0.0  # PE stall within those batches
    bytes_hot_written: int = 0  # bytes scattered into the hot store (prefill
                                # page fills + decode row commits, fused or
                                # eager)
    planned_preloads: int = 0   # restores issued through ensure_hot's
                                # planned d* batch
    unplanned_restores: int = 0  # demand restores outside a planned batch
    useful_preloads: int = 0    # restored pages read before re-eviction
    wasted_preloads: int = 0    # restored pages evicted/freed unread
    descriptors: List[TransferRequest] = dataclasses.field(default_factory=list)

    @property
    def modeled_latency_hidden(self) -> float:
        """Fraction of restore wall-time the planned preload overlapped."""
        if self.modeled_restore_time <= 0:
            return 1.0
        return 1.0 - self.modeled_restore_stall / self.modeled_restore_time

    def validate(self) -> None:
        """Cross-check the counters' arithmetic invariants; raises
        ValueError naming the broken one."""
        for name in ("page_faults", "evictions", "shared_hits",
                     "pages_allocated", "bytes_hot_written",
                     "planned_preloads", "unplanned_restores",
                     "useful_preloads", "wasted_preloads"):
            v = getattr(self, name)
            if v < 0:
                raise ValueError(f"PoolMetrics.{name} is negative ({v})")
        if (self.useful_preloads + self.wasted_preloads
                > self.planned_preloads + self.unplanned_restores):
            raise ValueError(
                "PoolMetrics: more preload outcomes (useful + wasted) than "
                "restores issued")
        if self.modeled_restore_time < 0 or self.modeled_restore_stall < 0:
            raise ValueError("PoolMetrics modeled restore times are negative")
        preloads = sum(1 for d in self.descriptors
                       if d.direction is Direction.PRELOAD)
        unloads = sum(1 for d in self.descriptors
                      if d.direction is Direction.UNLOAD)
        if preloads != self.page_faults:
            raise ValueError(
                f"PoolMetrics: {preloads} PRELOAD descriptors but "
                f"{self.page_faults} page faults (restores must be planned)")
        if unloads != self.evictions:
            raise ValueError(
                f"PoolMetrics: {unloads} UNLOAD descriptors but "
                f"{self.evictions} evictions")
        if self.page_faults > self.evictions:
            raise ValueError(
                f"PoolMetrics: {self.page_faults} restores exceed "
                f"{self.evictions} evictions — a page was restored that "
                "never spilled")
        hidden = self.modeled_latency_hidden
        if not 0.0 <= hidden <= 1.0:
            raise ValueError(
                f"PoolMetrics.modeled_latency_hidden = {hidden} out of "
                "[0, 1]")


@dataclasses.dataclass
class _PageMeta:
    frame: Optional[int]        # hot frame index, or None when cold
    refcount: int = 1
    last_used: int = 0
    shared_key: Optional[tuple] = None
    deadline: float = float("inf")   # owning request's TTFT deadline tick
    pending_read: bool = False  # restored but not yet read


ZERO_FRAME = 0      # reserved all-zeros frame (unallocated page-table slots)
TRASH_FRAME = 1     # reserved write sink (inactive slots' decode writes)
RESERVED_FRAMES = 2


class KVPagePool:
    """Physical page frames + residency + refcounts + tier movement.

    Storage is ``pool.planes`` (one plane per pageable cache leaf, on
    `device`); the cold tier ``pool.cold`` holds packed (P, F) host tensors.
    Frame ids, page ids, refcounts, eviction order, DMA descriptors and the
    lifecycle trace follow the reference pool."""

    def __init__(self, pcfg: PageConfig, *, layout: PackedKVLayout,
                 gqa_group: int = 1, dtype=torch.bfloat16, device="cuda",
                 tracer=None):
        self.cfg = pcfg
        self.layout = layout
        self.features = layout.features
        self.dtype = dtype
        self.device = torch.device(device)
        P = pcfg.page_tokens
        itemsize = torch.empty((), dtype=dtype).element_size()
        for e in layout.entries:
            # Hopper rule: a page slab streams as 16-byte cp.async chunks
            slab = P * e.feat[-1] * itemsize
            if slab % CP_ASYNC_BYTES:
                raise ValueError(
                    f"a ({P}, {e.feat[-1]}) page slab of {slab} B is not a "
                    f"multiple of the {CP_ASYNC_BYTES}-byte cp.async granule; "
                    "change page_tokens")
        self.page_bytes = P * self.features * itemsize
        self.row_bytes = self.features * itemsize
        n = max(pcfg.hot_frames, RESERVED_FRAMES + 1)
        self.planes: Dict[str, torch.Tensor] = layout.init_planes(
            n, P, dtype, self.device)
        self._n_frames = n
        self.n_layers = max((e.layers for e in layout.entries), default=1)
        self.free_frames: List[int] = list(range(RESERVED_FRAMES, n))
        self.pages: "OrderedDict[int, _PageMeta]" = OrderedDict()
        self.cold: Dict[int, torch.Tensor] = {}
        self.prefix_index: Dict[tuple, int] = {}
        self.metrics = PoolMetrics()
        self.trace: Optional[TraceLog] = TraceLog() if pcfg.trace else None
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._bridge_seq = 0
        self._next_id = 1
        self._clock = 0
        self.plan = plan_kv_page_stream(
            page_tokens=P, kv_features=self.features, tier=pcfg.slow_tier,
            pe=pcfg.pe, gqa_group=gqa_group, fifo_depth=pcfg.fifo_depth,
            itemsize=itemsize)
        self.distance = pcfg.preload_distance or self.plan.cfg.distance
        self._dma = DMAEngine(pcfg.slow_tier, pcfg.pe,
                              fifo_depth=pcfg.fifo_depth, tracer=self.tracer)
        self._flops_per_page = kv_page_flops(P, self.features, gqa_group)

    # ------------------------------------------------------------------ #
    @property
    def hot_frames(self) -> int:
        return self._n_frames

    @property
    def capacity(self) -> int:
        """Usable hot frames (page working set must fit here per step)."""
        return self.hot_frames - RESERVED_FRAMES

    def hot_in_use(self) -> int:
        return sum(1 for m in self.pages.values() if m.frame is not None)

    def packed_store(self) -> torch.Tensor:
        """The packed (NF, P, F) store: a materialized copy of the planes
        (the assembly path's gather source)."""
        return self.layout.pack_planes(self.planes)

    # ------------------------------------------------------------------ #
    # tier movement (cold tier stays packed)
    # ------------------------------------------------------------------ #
    def _read_frame(self, frame: int) -> torch.Tensor:
        rows = self.layout.read_frame_packed(self.planes, frame)
        if self.device.type == "cpu":
            return rows.clone()
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows)
        return host

    def _emit(self, kind: EventKind, **fields) -> None:
        if self.trace is not None:
            self.trace.emit(self._clock, kind, **fields)
        if self.tracer.enabled:
            seq = (self.trace.events[-1].seq if self.trace is not None
                   else self._bridge_seq)
            self._bridge_seq = seq + 1
            self.tracer.page_event(seq, self._clock, kind, fields)

    def tick(self) -> None:
        self._clock += 1
        self._emit(EventKind.TICK)

    def alloc(self, shared_key: Optional[tuple] = None, *,
              needed: Sequence[int] = ()) -> int:
        """Allocate a fresh page in the hot tier; returns its page id.
        `needed` (the step's working set) is never evicted to make room."""
        pid = self._next_id
        self._next_id += 1
        frame = self._take_frame(needed=needed)
        self.pages[pid] = _PageMeta(frame=frame, last_used=self._clock,
                                    shared_key=shared_key)
        if shared_key is not None:
            self.prefix_index[shared_key] = pid
        self.metrics.pages_allocated += 1
        self._emit(EventKind.ALLOC, pid=pid, frame=frame, refcount=1,
                   shared_key=shared_key)
        return pid

    def lookup_shared(self, key: tuple) -> Optional[int]:
        if not self.cfg.share_prefix_pages:
            return None
        pid = self.prefix_index.get(key)
        if pid is not None:
            self.pages[pid].refcount += 1
            self.metrics.shared_hits += 1
            self._emit(EventKind.REF, pid=pid,
                       refcount=self.pages[pid].refcount, shared_key=key)
        return pid

    def ref(self, pid: int) -> None:
        self.pages[pid].refcount += 1
        self._emit(EventKind.REF, pid=pid, refcount=self.pages[pid].refcount)

    def unref(self, pid: int) -> None:
        meta = self.pages[pid]
        meta.refcount -= 1
        self._emit(EventKind.UNREF, pid=pid, refcount=meta.refcount)
        if meta.refcount > 0:
            return
        if meta.pending_read:
            meta.pending_read = False
            self.metrics.wasted_preloads += 1
        if meta.shared_key is not None:
            self.prefix_index.pop(meta.shared_key, None)
        if meta.frame is not None:
            self.free_frames.append(meta.frame)
        self.cold.pop(pid, None)
        del self.pages[pid]
        self._emit(EventKind.FREE, pid=pid)

    # ------------------------------------------------------------------ #
    def note_deadline(self, pids: Sequence[int], deadline: float) -> None:
        """Tag pages with their owning request's TTFT-deadline tick; eviction
        takes the LATEST deadline first."""
        for pid in pids:
            self.pages[pid].deadline = deadline
            self._emit(EventKind.DEADLINE, pid=pid, deadline=deadline)

    def _take_frame(self, needed: Sequence[int]) -> int:
        """A free hot frame, evicting pages not in `needed` — latest request
        deadline first, then LRU within a tie."""
        if self.free_frames:
            return self.free_frames.pop()
        needed = set(needed)
        victims = sorted(
            ((-m.deadline, m.last_used), pid) for pid, m in self.pages.items()
            if m.frame is not None and pid not in needed)
        if not victims:
            raise RuntimeError(
                f"hot tier exhausted: {self.capacity} frames all needed this "
                "step; raise PageConfig.hot_frames or admit fewer tokens")
        _, victim = victims[0]
        self.evict(victim, cause="steal", pinned=needed)
        return self.free_frames.pop()

    def evict(self, pid: int, *, cause: str = "explicit",
              pinned: Sequence[int] = ()) -> None:
        """Hot -> cold: the frame's rows go to a host tensor, plus an
        UNLOAD descriptor."""
        meta = self.pages[pid]
        if meta.frame is None:
            raise RuntimeError(f"page {pid} already cold")
        if meta.pending_read:
            meta.pending_read = False
            self.metrics.wasted_preloads += 1
        self._emit(EventKind.EVICT, pid=pid, frame=meta.frame, cause=cause,
                   pinned=tuple(sorted(pinned)))
        self.cold[pid] = self._read_frame(meta.frame)
        self.free_frames.append(meta.frame)
        self.metrics.evictions += 1
        self.metrics.descriptors.append(TransferRequest(
            Direction.UNLOAD, src=meta.frame * self.page_bytes,
            dst=pid * self.page_bytes, nbytes=self.page_bytes, tag=pid))
        meta.frame = None

    def evict_pages(self, pids: Sequence[int]) -> None:
        for pid in pids:
            if self.pages[pid].frame is not None:
                self.evict(pid)

    def ensure_hot(self, pids: Sequence[int]) -> int:
        """Restore any cold page in `pids` as one planned batch (preload
        distance d*, BATCH order, replayed on the DMA twin); returns the
        page-fault count."""
        self.tick()
        faults = []
        for pid in pids:
            meta = self.pages[pid]
            meta.last_used = self._clock
            self._emit(EventKind.TOUCH, pid=pid)
            if meta.frame is None:
                faults.append(pid)
        for pid in faults:
            meta = self.pages[pid]
            frame = self._take_frame(needed=pids)
            self.layout.write_frame_packed(self.planes, frame, self.cold.pop(pid))
            meta.frame = frame
            meta.pending_read = True
            self._emit(EventKind.RESTORE, pid=pid, frame=frame)
            self.metrics.descriptors.append(TransferRequest(
                Direction.PRELOAD, src=pid * self.page_bytes,
                dst=frame * self.page_bytes, nbytes=self.page_bytes, tag=pid))
        if faults:
            self.metrics.page_faults += len(faults)
            self.metrics.planned_preloads += len(faults)
            stats = run_kv_page_workload(
                self._dma,
                KVPageWorkload(page_bytes=self.page_bytes,
                               flops_per_page=self._flops_per_page,
                               pages_per_step=len(faults), steps=1),
                distance=self.distance)
            self.metrics.modeled_restore_time += stats.total_time
            self.metrics.modeled_restore_stall += stats.stall_time
        return len(faults)

    # ------------------------------------------------------------------ #
    def frames_of(self, pids: Sequence[Optional[int]]) -> np.ndarray:
        """Physical frame per page id (ZERO_FRAME for unallocated slots).
        All pages must be hot (call ensure_hot first)."""
        out = np.full((len(pids),), ZERO_FRAME, np.int32)
        for i, pid in enumerate(pids):
            if pid is None:
                continue
            meta = self.pages[pid]
            if meta.pending_read:
                meta.pending_read = False
                self.metrics.useful_preloads += 1
            if self.trace is not None or self.tracer.enabled:
                self._emit(EventKind.READ, pid=pid, frame=meta.frame)
            if meta.frame is None:
                raise RuntimeError(f"page {pid} is cold at read time")
            out[i] = meta.frame
        return out

    def write_page(self, pid: int, rows: torch.Tensor, n_valid: int) -> None:
        """Fill (a prefix of) one hot page with packed KV rows."""
        meta = self.pages[pid]
        self._emit(EventKind.WRITE_PAGE, pid=pid, frame=meta.frame,
                   n_valid=n_valid)
        pad = self.cfg.page_tokens - n_valid
        rows = rows[:n_valid]
        if pad:
            rows = F.pad(rows, (0, 0, 0, pad))
        self.layout.write_frame_packed(self.planes, meta.frame, rows)
        self.metrics.bytes_hot_written += self.page_bytes

    def _check_commit(self, frames: np.ndarray) -> None:
        if ZERO_FRAME in frames.tolist():
            raise ValueError("write to the zero frame")
        live = sum(1 for f in frames.tolist() if f != TRASH_FRAME)
        self.metrics.bytes_hot_written += live * self.row_bytes

    def write_rows(self, frames: np.ndarray, offsets: np.ndarray,
                   rows: torch.Tensor) -> None:
        """Eagerly commit one packed row per slot at (frame, offset) — the
        out-of-kernel half of the commit contract (per-layer decode)."""
        self._emit(EventKind.WRITE_ROWS,
                   frames=tuple(int(f) for f in frames))
        self._check_commit(frames)
        dev = self.device
        self.layout.commit_token(
            self.planes, rows,
            torch.as_tensor(frames, dtype=torch.long, device=dev),
            torch.as_tensor(offsets, dtype=torch.long, device=dev))

    def note_fused_commit(self, frames: np.ndarray,
                          offsets: np.ndarray) -> None:
        """Account a FUSED commit (the sweep kernel's epilogue writes the
        rows): validation, byte accounting and the lifecycle trace only, one
        WRITE_ROWS per layer. Call BEFORE the kernel."""
        del offsets
        for layer in range(self.n_layers):
            self._emit(EventKind.WRITE_ROWS, layer=layer,
                       frames=tuple(int(f) for f in frames))
        self._check_commit(frames)
