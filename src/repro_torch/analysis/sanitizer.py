"""Page-lifecycle sanitizer: replay a trace against the formal state machine.

A copy of the reference package's ``analysis/sanitizer.py``: pure Python
over :mod:`repro_torch.analysis.events`, so the same rules judge the
port's page pool.

The lifecycle contract of ``serving.kv_pages.KVPagePool``:

  ALLOC ->  HOT --EVICT-->  COLD --RESTORE--> HOT ...  --FREE--> gone
             |                                   |
           READ / WRITE (hot only)          (no reads/writes while cold)

plus three cross-page invariants:

  * refcounts never go below zero, and every page is freed eventually;
  * capacity ("steal") evictions pick the victim with the LATEST deadline,
    then least-recently-used — a page racing its deadline is never spilled
    while a page with slack sits hot;
  * a page is never evicted and restored within the same pool clock step
    (the churn bug class: an allocation stealing a frame the very step
    just restored).

:class:`LifecycleChecker` consumes events incrementally (so the engine's
``shadow_check`` mode stays O(new events) per tick) and reports each broken
invariant as a :class:`Violation` carrying the offending event, the page id,
and the page's full event history — the violation is visible at the point
of violation, not N ticks later as a token mismatch.

Violation rules (the ``Violation.rule`` vocabulary):

  refcount-underflow    unref of a freed/unknown page, or refcount < 0
  refcount-leak         page still alive when the trace is finalized
  use-after-evict       read/write of a page that is cold or freed
  write-to-non-hot-frame  row scatter into the reserved zero frame, a free
                        frame, or any frame not backing a hot page
  double-restore        restore of a page that is already hot
  double-evict          evict of a page that is already cold (or freed)
  evict-restore-churn   same page evicted and restored in one clock step
  deadline-order        steal eviction whose victim was not the
                        latest-deadline (then LRU) evictable page
  frame-collision       alloc/restore into an occupied or reserved frame
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.events import EventKind, PageEvent

# mirror serving.kv_pages without importing it (keeps this package torch-free)
ZERO_FRAME = 0
TRASH_FRAME = 1
RESERVED_FRAMES = 2

_HOT, _COLD, _FREED = "hot", "cold", "freed"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken lifecycle invariant, with event-level provenance."""

    rule: str
    message: str
    event: PageEvent                    # the event AT which the break occurred
    pid: Optional[int] = None
    history: Tuple[PageEvent, ...] = ()  # the page's prior events, in order

    @property
    def seq(self) -> int:
        return self.event.seq

    @property
    def clock(self) -> int:
        return self.event.clock

    def describe(self) -> str:
        lines = [f"[{self.rule}] {self.message}",
                 f"    at event {self.event.describe()}"]
        if self.history:
            lines.append("    page history:")
            lines.extend(f"      {e.describe()}" for e in self.history)
        return "\n".join(lines)


class LifecycleViolationError(AssertionError):
    """Raised by shadow_check mode: the trace broke the lifecycle contract."""

    def __init__(self, violations: Sequence[Violation]):
        self.violations = list(violations)
        super().__init__(format_violations(self.violations))


def format_violations(violations: Sequence[Violation]) -> str:
    if not violations:
        return "no lifecycle violations"
    body = "\n".join(v.describe() for v in violations)
    return f"{len(violations)} page-lifecycle violation(s):\n{body}"


@dataclasses.dataclass
class _PageState:
    state: str                      # _HOT | _COLD | _FREED
    frame: Optional[int]
    refcount: int
    last_used: int
    layer: Optional[int] = None     # plane scope of the frame claim
    deadline: float = math.inf
    last_evict_clock: int = -1
    last_restore_clock: int = -1
    history: List[PageEvent] = dataclasses.field(default_factory=list)


class LifecycleChecker:
    """Stateful replay of a page-event trace; collects violations.

    Frame identifiers are scoped ``(layer, frame)``: the v2 per-layer page
    store holds one hot array PER LAYER, so the same frame number names a
    distinct row range in every plane. An event with ``layer=None`` claims
    or writes the WHOLE physical frame (every plane at once) — the pool's
    allocator works at that granularity — while per-layer events (the fused
    sweep commit's WRITE_ROWS) touch exactly one plane. Two pages may
    therefore coexist on one frame number in *different* layers without a
    collision, but a same-layer overlap (or any overlap with a whole-frame
    claim) is still flagged."""

    def __init__(self) -> None:
        self.pages: Dict[int, _PageState] = {}
        # hot frame -> {layer or None (whole frame): pid}
        self.frame_owner: Dict[int, Dict[Optional[int], int]] = {}
        self.violations: List[Violation] = []
        self._consumed = 0

    # ------------------------------------------------------------------ #
    def _flag(self, rule: str, ev: PageEvent, message: str,
              pid: Optional[int] = None) -> None:
        pid = pid if pid is not None else ev.pid
        hist: Tuple[PageEvent, ...] = ()
        if pid is not None and pid in self.pages:
            hist = tuple(self.pages[pid].history)
        self.violations.append(
            Violation(rule=rule, message=message, event=ev, pid=pid,
                      history=hist))

    def _page(self, ev: PageEvent) -> Optional[_PageState]:
        return self.pages.get(ev.pid) if ev.pid is not None else None

    def _owner_of(self, layer: Optional[int],
                  frame: int) -> Optional[int]:
        """Resolve the pid owning ``(layer, frame)``: a layer-scoped claim
        wins, falling back to the whole-frame (layer=None) owner."""
        owners = self.frame_owner.get(frame, {})
        if layer is not None and layer in owners:
            return owners[layer]
        return owners.get(None)

    def _claim_frame(self, ev: PageEvent, pid: int,
                     frame: Optional[int]) -> None:
        if frame is None:
            return
        layer = ev.layer
        owners = self.frame_owner.setdefault(frame, {})
        if frame < RESERVED_FRAMES:
            self._flag("frame-collision", ev,
                       f"page {pid} placed into reserved frame {frame}")
        else:
            # whole-frame claims conflict with every plane; a layer-scoped
            # claim only with its own plane or a whole-frame owner
            rivals = (owners.values() if layer is None else
                      [o for l, o in owners.items()
                       if l is None or l == layer])
            rival = next((o for o in rivals if o != pid), None)
            if rival is not None:
                scope = "" if layer is None else f" (layer {layer})"
                self._flag("frame-collision", ev,
                           f"frame {frame}{scope} already backs hot page "
                           f"{rival}")
        owners[layer] = pid

    def _release_frame(self, pid: int, frame: Optional[int],
                       layer: Optional[int] = None) -> None:
        owners = self.frame_owner.get(frame)
        if owners is None:
            return
        if layer is None:
            # whole-frame release drops every claim this pid holds here
            for l in [l for l, o in owners.items() if o == pid]:
                del owners[l]
        elif owners.get(layer) == pid:
            del owners[layer]
        if not owners:
            self.frame_owner.pop(frame, None)

    # ------------------------------------------------------------------ #
    def feed(self, events: Iterable[PageEvent]) -> List[Violation]:
        """Consume new events; returns the violations they introduced."""
        before = len(self.violations)
        for ev in events:
            self._step(ev)
        return self.violations[before:]

    def feed_log(self, log) -> List[Violation]:
        """Consume a TraceLog incrementally (only events not yet seen)."""
        new = log.events[self._consumed:]
        self._consumed = len(log.events)
        return self.feed(new)

    # ------------------------------------------------------------------ #
    def _step(self, ev: PageEvent) -> None:
        kind = ev.kind
        if kind is EventKind.TICK:
            return
        if kind is EventKind.WRITE_ROWS:
            self._check_write_rows(ev)
            return

        ps = self._page(ev)
        if kind is EventKind.ALLOC:
            if ps is not None and ps.state is not _FREED:
                self._flag("frame-collision", ev,
                           f"page {ev.pid} allocated twice")
            self.pages[ev.pid] = ps = _PageState(
                state=_HOT, frame=ev.frame,
                refcount=ev.refcount if ev.refcount is not None else 1,
                last_used=ev.clock, layer=ev.layer)
            self._claim_frame(ev, ev.pid, ev.frame)
            ps.history.append(ev)
            return

        if ps is None or ps.state is _FREED:
            gone = "freed" if ps is not None else "unknown"
            if kind is EventKind.UNREF:
                self._flag("refcount-underflow", ev,
                           f"unref of {gone} page {ev.pid}")
            elif kind in (EventKind.READ, EventKind.WRITE_PAGE):
                self._flag("use-after-evict", ev,
                           f"{kind.value} of {gone} page {ev.pid}")
            elif kind is EventKind.EVICT:
                self._flag("double-evict", ev,
                           f"evict of {gone} page {ev.pid}")
            elif kind is EventKind.RESTORE:
                self._flag("double-restore", ev,
                           f"restore of {gone} page {ev.pid}")
            # REF/TOUCH/DEADLINE on an unknown page: tracked pages only
            elif kind is EventKind.REF:
                self._flag("refcount-underflow", ev,
                           f"ref of {gone} page {ev.pid}")
            return

        ps.history.append(ev)
        handler = {
            EventKind.REF: self._on_ref,
            EventKind.UNREF: self._on_unref,
            EventKind.FREE: self._on_free,
            EventKind.EVICT: self._on_evict,
            EventKind.RESTORE: self._on_restore,
            EventKind.TOUCH: self._on_touch,
            EventKind.READ: self._on_read,
            EventKind.WRITE_PAGE: self._on_write_page,
            EventKind.DEADLINE: self._on_deadline,
        }[kind]
        handler(ev, ps)

    # ------------------------------------------------------------------ #
    def _on_ref(self, ev: PageEvent, ps: _PageState) -> None:
        ps.refcount += 1

    def _on_unref(self, ev: PageEvent, ps: _PageState) -> None:
        ps.refcount -= 1
        if ps.refcount < 0:
            self._flag("refcount-underflow", ev,
                       f"page {ev.pid} refcount fell to {ps.refcount}")

    def _on_free(self, ev: PageEvent, ps: _PageState) -> None:
        if ps.refcount > 0:
            self._flag("refcount-underflow", ev,
                       f"page {ev.pid} freed with refcount {ps.refcount} "
                       "still outstanding")
        self._release_frame(ev.pid, ps.frame, ps.layer)
        ps.state = _FREED
        ps.frame = None

    def _on_evict(self, ev: PageEvent, ps: _PageState) -> None:
        if ps.state is not _HOT:
            self._flag("double-evict", ev,
                       f"evict of page {ev.pid} which is already {ps.state}")
            return
        if ev.cause == "steal":
            self._check_victim_order(ev, ps)
        if ps.last_restore_clock == ev.clock:
            self._flag("evict-restore-churn", ev,
                       f"page {ev.pid} restored and evicted within clock "
                       f"step {ev.clock} (same-step churn)")
        ps.last_evict_clock = ev.clock
        self._release_frame(ev.pid, ps.frame, ps.layer)
        ps.state = _COLD
        ps.frame = None

    def _on_restore(self, ev: PageEvent, ps: _PageState) -> None:
        if ps.state is _HOT:
            self._flag("double-restore", ev,
                       f"restore of page {ev.pid} which is already hot in "
                       f"frame {ps.frame}")
            return
        if ps.last_evict_clock == ev.clock:
            self._flag("evict-restore-churn", ev,
                       f"page {ev.pid} evicted and restored within clock "
                       f"step {ev.clock} (same-step churn)")
        ps.last_restore_clock = ev.clock
        ps.state = _HOT
        ps.frame = ev.frame
        ps.layer = ev.layer
        self._claim_frame(ev, ev.pid, ev.frame)

    def _on_touch(self, ev: PageEvent, ps: _PageState) -> None:
        ps.last_used = ev.clock

    def _on_read(self, ev: PageEvent, ps: _PageState) -> None:
        if ps.state is not _HOT:
            self._flag("use-after-evict", ev,
                       f"read of page {ev.pid} which is {ps.state}")

    def _on_write_page(self, ev: PageEvent, ps: _PageState) -> None:
        if ps.state is not _HOT:
            self._flag("use-after-evict", ev,
                       f"write to page {ev.pid} which is {ps.state}")

    def _on_deadline(self, ev: PageEvent, ps: _PageState) -> None:
        if ev.deadline is not None:
            ps.deadline = ev.deadline

    # ------------------------------------------------------------------ #
    def _check_victim_order(self, ev: PageEvent, victim: _PageState) -> None:
        """A steal eviction must pick the latest-deadline, then least-
        recently-used, hot page outside the pinned working set."""
        pinned = set(ev.pinned)
        for pid, ps in self.pages.items():
            if pid == ev.pid or ps.state is not _HOT or pid in pinned:
                continue
            later = ps.deadline > victim.deadline
            tie_lru = (ps.deadline == victim.deadline
                       and ps.last_used < victim.last_used)
            if later or tie_lru:
                why = (f"deadline {ps.deadline} > {victim.deadline}" if later
                       else f"equal deadline but older last_used "
                            f"{ps.last_used} < {victim.last_used}")
                self._flag("deadline-order", ev,
                           f"steal evicted page {ev.pid} while page {pid} "
                           f"was the better victim ({why})")
                return

    def _check_write_rows(self, ev: PageEvent) -> None:
        where = "" if ev.layer is None else f" (layer {ev.layer})"
        for slot, frame in enumerate(ev.frames):
            if frame == TRASH_FRAME:
                continue                    # designated write sink: fine
            if frame == ZERO_FRAME:
                self._flag("write-to-non-hot-frame", ev,
                           f"slot {slot} scattered a row into the reserved "
                           "zero frame (unallocated page-table slots must "
                           "stay all-zeros)",
                           pid=self._owner_of(ev.layer, frame))
            elif self._owner_of(ev.layer, frame) is None:
                self._flag("write-to-non-hot-frame", ev,
                           f"slot {slot} scattered a row into frame "
                           f"{frame}{where} which backs no hot page")

    # ------------------------------------------------------------------ #
    def finalize(self) -> List[Violation]:
        """End-of-trace checks: every page must have been freed."""
        before = len(self.violations)
        for pid, ps in sorted(self.pages.items()):
            if ps.state is _FREED:
                continue
            last = ps.history[-1] if ps.history else PageEvent(
                seq=-1, clock=-1, kind=EventKind.ALLOC, pid=pid)
            self._flag("refcount-leak", last,
                       f"page {pid} never freed (refcount {ps.refcount}, "
                       f"state {ps.state}) — leaked at end of trace",
                       pid=pid)
        return self.violations[before:]


def check_page_trace(events: Iterable[PageEvent], *,
                     final: bool = False) -> List[Violation]:
    """One-shot replay: feed every event, optionally run end-of-trace
    (leak) checks, and return all violations found."""
    checker = LifecycleChecker()
    checker.feed(events)
    if final:
        checker.finalize()
    return checker.violations
