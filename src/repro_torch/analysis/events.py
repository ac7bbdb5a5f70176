"""Typed page-lifecycle events: the sanitizer's input format.

``KVPagePool`` emits one :class:`PageEvent` per state transition when
``PageConfig.trace=True`` (and emits nothing — not even a branch into a
logging call — when tracing is off, so the production hot path pays zero
overhead). The trace is an append-only log; the reference package's sanitizer
replays it against the formal lifecycle state machine (the port's copy of
the sanitizer is still to come).

Events deliberately carry *plain* data (ints, floats, tuples) — no device
arrays, no references into the pool — so a trace can be pickled, diffed,
or replayed long after the pool is gone, and so constructing synthetic
traces for failing-by-construction fixtures is trivial.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, List, Optional, Tuple


class EventKind(str, enum.Enum):
    """Every observable transition of a page's lifecycle."""

    ALLOC = "alloc"          # fresh page enters the hot tier
    REF = "ref"              # refcount incremented (explicit or shared hit)
    UNREF = "unref"          # refcount decremented
    FREE = "free"            # refcount reached zero; page ceases to exist
    EVICT = "evict"          # hot -> cold (frame released)
    RESTORE = "restore"      # cold -> hot (frame reacquired)
    TOUCH = "touch"          # page named in a step's working set (LRU update)
    READ = "read"            # page's frame handed to a decode gather/kernel
    WRITE_PAGE = "write_page"    # whole-page fill (prefill rows)
    WRITE_ROWS = "write_rows"    # one-row-per-slot decode scatter (by frame)
    DEADLINE = "deadline"    # page tagged with its owner's deadline tick
    TICK = "tick"            # pool clock advanced (step boundary)


@dataclasses.dataclass(frozen=True)
class PageEvent:
    """One recorded lifecycle transition.

    Attributes:
      seq: position in the trace (unique, monotonically increasing).
      clock: pool clock at emission (same-clock events happened in one step).
      kind: the transition type.
      pid: page id, or None for page-less events (TICK, WRITE_ROWS).
      frame: physical hot frame involved, if any.
      refcount: page refcount AFTER the event (REF/UNREF/ALLOC).
      deadline: deadline tick carried by DEADLINE events.
      cause: EVICT provenance — "steal" (capacity eviction, must follow
        deadline-then-LRU victim order) or "explicit" (policy swap-out /
        pause, exempt from victim-order checks).
      pinned: page ids the evictor was told it must not touch (EVICT/steal).
      frames: physical frame per slot for WRITE_ROWS events.
      n_valid: valid row count for WRITE_PAGE events.
      shared_key: prefix-sharing key for ALLOC/REF events, when present.
      layer: which per-layer KV plane the event's frame identifier lives in
        (v2 layout: the hot tier is one array PER LAYER, so frame f exists
        once per plane). ``None`` means the event spans every plane at once
        — the claim/write covers the whole physical frame. The fused sweep
        commit emits one WRITE_ROWS per layer with ``layer`` set; the
        sanitizer keys frame ownership by ``(layer, frame)`` so a same-frame
        write in a DIFFERENT layer is not a collision while one in the SAME
        layer still is.
    """

    seq: int
    clock: int
    kind: EventKind
    pid: Optional[int] = None
    frame: Optional[int] = None
    layer: Optional[int] = None
    refcount: Optional[int] = None
    deadline: Optional[float] = None
    cause: Optional[str] = None
    pinned: Tuple[int, ...] = ()
    frames: Tuple[int, ...] = ()
    n_valid: Optional[int] = None
    shared_key: Optional[tuple] = None

    def describe(self) -> str:
        bits = [f"#{self.seq} t={self.clock} {self.kind.value}"]
        if self.pid is not None:
            bits.append(f"page={self.pid}")
        if self.frame is not None:
            bits.append(f"frame={self.frame}")
        if self.layer is not None:
            bits.append(f"layer={self.layer}")
        if self.refcount is not None:
            bits.append(f"refcount={self.refcount}")
        if self.cause is not None:
            bits.append(f"cause={self.cause}")
        if self.frames:
            bits.append(f"frames={list(self.frames)}")
        if self.deadline is not None:
            bits.append(f"deadline={self.deadline}")
        return " ".join(bits)


class TraceLog:
    """Append-only event log with monotonic sequence numbers.

    ``emit`` assigns ``seq`` itself so callers (including broken-by-design
    test drivers emitting synthetic events) can never produce a trace with
    ambiguous ordering.
    """

    def __init__(self) -> None:
        self.events: List[PageEvent] = []

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[PageEvent]:
        return iter(self.events)

    def emit(self, clock: int, kind: EventKind, **fields) -> PageEvent:
        ev = PageEvent(seq=len(self.events), clock=clock, kind=kind, **fields)
        self.events.append(ev)
        return ev

    def clear(self) -> None:
        self.events.clear()

    def for_page(self, pid: int) -> List[PageEvent]:
        """Provenance view: every event touching page ``pid``, in order."""
        return [e for e in self.events if e.pid == pid]
