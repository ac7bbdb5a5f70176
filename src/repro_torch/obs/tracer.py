"""Structured tracing for the PUL serving stack.

One :class:`Tracer` instance is threaded through every layer — the paged
engine (tick/prefill/chunk/decode spans, request lifecycles), the admission
scheduler (decisions with their *reason*), the KV page pool (the
``analysis.events`` lifecycle trace bridged into the same stream), and the
DMA twin (per-channel FIFO occupancy, descriptor spans, back-pressure
stalls) — so a serving run produces ONE timeline that Perfetto / Chrome
``about:tracing`` can load directly (:meth:`Tracer.to_chrome`).

Design rules:

  * **Zero overhead when off.** :data:`NULL_TRACER` (the default everywhere)
    is ``enabled=False`` and every method is a no-op returning a shared null
    context; no event object, dict, or string is ever allocated on the
    untraced hot path. Callers that would build an args dict guard on
    ``tracer.enabled`` first.
  * **Two clocks.** Serving-side events carry a *wall* timestamp (µs since
    the tracer was created, monotonic ``perf_counter``) plus the engine
    *tick* in ``args``; DMA-twin events carry *model* time (the discrete-
    event simulator's clock, µs) on their own process track, offset so
    successive restore batches lay out sequentially. Perfetto renders both;
    they are different time bases and are labeled as such.
  * **Spans nest or they don't exist.** Synchronous spans come from
    ``with tracer.span(...)``; the explicit ``begin_span``/``end_span``
    pair exists for call sites that cannot use ``with`` but MUST balance
    within one function scope (lint rule PUL106 enforces this). Work that
    genuinely crosses scopes — a request's life from submit to last token,
    a slot's occupancy — uses *async* spans (``async_begin``/``async_end``,
    Chrome ``b``/``e`` phases keyed by id), which are exempt from PUL106 by
    design.

Events are plain dataclasses with JSON-safe args (tuples become lists,
``inf`` becomes the string ``"inf"``), so a trace survives export → parse →
replay; :func:`page_events_from_chrome` rebuilds the page-lifecycle
``PageEvent`` stream from an exported file, which the round-trip tests feed
back through the sanitizer's ``LifecycleChecker``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
from typing import Any, Dict, List, Optional, Tuple

# Chrome trace-event phases this tracer emits
PH_BEGIN = "B"          # synchronous span open
PH_END = "E"            # synchronous span close
PH_COMPLETE = "X"       # span with explicit ts + dur (DMA descriptors)
PH_INSTANT = "i"        # point event (decisions, preemptions, page events)
PH_COUNTER = "C"        # sampled counter (FIFO occupancy, pool gauges)
PH_ASYNC_BEGIN = "b"    # cross-scope span open (requests, slot occupancy)
PH_ASYNC_END = "e"      # cross-scope span close
PHASES = {PH_BEGIN, PH_END, PH_COMPLETE, PH_INSTANT, PH_COUNTER,
          PH_ASYNC_BEGIN, PH_ASYNC_END}

# process ids in the exported trace: serving-side tracks run on wall-clock
# microseconds; the DMA twin's tracks run on (offset) model time
PID_SERVING = 1
PID_DMA = 2


def _json_safe(value: Any) -> Any:
    """Args must survive json.dump -> json.load bit-for-bit: tuples become
    lists, non-finite floats become strings (Perfetto rejects Infinity)."""
    if isinstance(value, (tuple, list)):
        return [_json_safe(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, float) and not math.isfinite(value):
        return "inf" if value > 0 else ("-inf" if value < 0 else "nan")
    return value


def _json_restore(value: Any) -> Any:
    """Inverse of :func:`_json_safe` for scalar sentinels (lists stay lists;
    page-event reconstruction re-tuples the fields that need it)."""
    if value == "inf":
        return math.inf
    if value == "-inf":
        return -math.inf
    if value == "nan":
        return math.nan
    return value


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One recorded event (1:1 with a Chrome trace-event JSON object)."""

    ph: str                         # phase (see PH_* above)
    track: str                      # logical track -> tid in the export
    name: str
    ts: float                       # microseconds on the track's clock
    tick: int                       # engine tick at emission (-1: n/a)
    dur: Optional[float] = None     # PH_COMPLETE only
    span_id: Optional[int] = None   # async phases only
    cat: str = ""                   # category ("decision", "page", ...)
    args: Optional[Dict[str, Any]] = None


class Tracer:
    """Append-only event recorder with Chrome/Perfetto export."""

    enabled: bool = True

    def __init__(self) -> None:
        self.events: List[TraceEvent] = []
        self._t0 = time.perf_counter()
        self._tick = -1

    # ------------------------------------------------------------------ #
    # clocks
    # ------------------------------------------------------------------ #
    def now_us(self) -> float:
        """Wall microseconds since tracer creation (monotonic)."""
        return (time.perf_counter() - self._t0) * 1e6

    def set_tick(self, tick: int) -> None:
        """Anchor subsequent events to engine tick `tick`."""
        self._tick = tick

    # ------------------------------------------------------------------ #
    # emission
    # ------------------------------------------------------------------ #
    def _emit(self, ph: str, track: str, name: str, *,
              ts: Optional[float] = None, dur: Optional[float] = None,
              span_id: Optional[int] = None, cat: str = "",
              args: Optional[Dict[str, Any]] = None) -> None:
        self.events.append(TraceEvent(
            ph=ph, track=track, name=name,
            ts=self.now_us() if ts is None else ts,
            tick=self._tick, dur=dur, span_id=span_id, cat=cat,
            args=_json_safe(args) if args else None))

    def begin_span(self, track: str, name: str, **args) -> None:
        """Open a synchronous span. MUST be balanced by `end_span` in the
        same function scope (PUL106); prefer `with tracer.span(...)`."""
        self._emit(PH_BEGIN, track, name, args=args or None)

    def end_span(self, track: str, name: str = "") -> None:
        self._emit(PH_END, track, name)

    @contextlib.contextmanager
    def span(self, track: str, name: str, **args):
        """Synchronous span as a context manager (the preferred form)."""
        self.begin_span(track, name, **args)
        try:
            yield
        finally:
            self.end_span(track, name)

    def complete(self, track: str, name: str, *, ts: float, dur: float,
                 cat: str = "", **args) -> None:
        """Span with explicit start/duration (model-time DMA descriptors)."""
        self._emit(PH_COMPLETE, track, name, ts=ts, dur=max(dur, 0.0),
                   cat=cat, args=args or None)

    def instant(self, track: str, name: str, *, cat: str = "",
                ts: Optional[float] = None, **args) -> None:
        self._emit(PH_INSTANT, track, name, ts=ts, cat=cat,
                   args=args or None)

    def counter(self, track: str, name: str, value: float, *,
                ts: Optional[float] = None) -> None:
        self._emit(PH_COUNTER, track, name, ts=ts,
                   args={"value": value})

    def async_begin(self, track: str, name: str, span_id: int,
                    *, cat: str = "async", **args) -> None:
        """Open a cross-scope span (request lifecycle, slot occupancy).
        Paired by (cat, span_id), not by call scope — exempt from PUL106."""
        self._emit(PH_ASYNC_BEGIN, track, name, span_id=span_id, cat=cat,
                   args=args or None)

    def async_end(self, track: str, name: str, span_id: int,
                  *, cat: str = "async", **args) -> None:
        self._emit(PH_ASYNC_END, track, name, span_id=span_id, cat=cat,
                   args=args or None)

    def decision(self, name: str, **args) -> None:
        """Scheduler/engine decision point (admission, rejection,
        preemption) with its machine-readable *reason* — the events
        `tools/trace_diff.py` aligns two runs on."""
        self.instant("sched", name, cat="decision", **args)

    def page_event(self, seq: int, clock: int, kind, fields: Dict[str, Any]):
        """Bridge one `analysis.events` page-lifecycle transition into the
        stream (kind is an EventKind; fields are the PageEvent fields)."""
        args = {"seq": seq, "clock": clock}
        for k, v in fields.items():
            if v is None or (isinstance(v, tuple) and not v):
                continue                    # drop empties: smaller traces
            args["page" if k == "pid" else k] = v
        self.instant("pages", getattr(kind, "value", str(kind)),
                     cat="page", **args)

    # ------------------------------------------------------------------ #
    # export
    # ------------------------------------------------------------------ #
    def _track_ids(self) -> Dict[str, Tuple[int, int]]:
        """Stable track -> (pid, tid) assignment; DMA-model tracks get
        their own process (their clock is simulator time, not wall)."""
        out: Dict[str, Tuple[int, int]] = {}
        tids = {PID_SERVING: 0, PID_DMA: 0}
        for ev in self.events:
            if ev.track not in out:
                pid = PID_DMA if ev.track.startswith("dma") else PID_SERVING
                tids[pid] += 1
                out[ev.track] = (pid, tids[pid])
        return out

    def to_chrome(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Export as a Chrome/Perfetto trace-event JSON object (and write
        it to `path` when given)."""
        tracks = self._track_ids()
        events: List[Dict[str, Any]] = []
        for pid, label in ((PID_SERVING, "serving (wall clock)"),
                           (PID_DMA, "dma-twin (model time)")):
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "ts": 0,
                           "args": {"name": label}})
        for track, (pid, tid) in tracks.items():
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "ts": 0, "args": {"name": track}})
        for ev in self.events:
            pid, tid = tracks[ev.track]
            obj: Dict[str, Any] = {
                "ph": ev.ph, "name": ev.name, "pid": pid, "tid": tid,
                "ts": ev.ts,
            }
            if ev.cat:
                obj["cat"] = ev.cat
            args = dict(ev.args) if ev.args else {}
            if ev.tick >= 0 and ev.ph != PH_COUNTER:
                # counters stay pure: every args key of a 'C' event renders
                # as its own series, and tick-as-a-series is noise
                args["tick"] = ev.tick
            if args:
                obj["args"] = args
            if ev.ph == PH_COMPLETE:
                obj["dur"] = ev.dur
            if ev.ph in (PH_ASYNC_BEGIN, PH_ASYNC_END):
                obj["id"] = ev.span_id
                obj.setdefault("cat", "async")
            if ev.ph == PH_INSTANT:
                obj["s"] = "t"
            events.append(obj)
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "format": "pul-trace-v1",
                "tracks": {t: {"pid": p, "tid": i}
                           for t, (p, i) in tracks.items()},
            },
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


class NullTracer(Tracer):
    """The off switch: every method is a no-op; nothing is ever allocated.

    `enabled=False` lets hot paths skip building args dicts entirely; the
    shared null context makes `with tracer.span(...)` free of per-call
    allocation too."""

    enabled = False
    _NULL_CTX = contextlib.nullcontext()

    def __init__(self) -> None:          # no event list, no clock
        self.events = ()                 # immutable + empty: nothing recorded

    def now_us(self) -> float:
        return 0.0

    def set_tick(self, tick: int) -> None:
        pass

    def _emit(self, *a, **kw) -> None:
        pass

    def span(self, track: str, name: str, **args):
        return self._NULL_CTX

    def to_chrome(self, path: Optional[str] = None) -> Dict[str, Any]:
        raise RuntimeError("NullTracer records nothing; nothing to export")


NULL_TRACER = NullTracer()


# ---------------------------------------------------------------------- #
# load / validate / reconstruct
# ---------------------------------------------------------------------- #
def load_chrome_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema-check an exported trace; returns human-readable errors
    (empty list = valid). Checks the Chrome trace-event contract Perfetto
    relies on: required keys per phase, known phases, numeric finite
    timestamps, balanced B/E per (pid, tid), paired async b/e per
    (cat, id), non-negative X durations."""
    errors: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["top level must be an object with a 'traceEvents' list"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    stacks: Dict[Tuple[int, int], List[str]] = {}
    async_open: Dict[Tuple[str, Any], int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event #{i}: not an object")
            continue
        ph = ev.get("ph")
        if ph == "M":
            continue                    # metadata: free-form
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                errors.append(f"event #{i} ({ph}): missing '{key}'")
        if ph not in PHASES:
            errors.append(f"event #{i}: unknown phase {ph!r}")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts):
            errors.append(f"event #{i}: non-finite ts {ts!r}")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == PH_BEGIN:
            stacks.setdefault(key, []).append(ev.get("name", ""))
        elif ph == PH_END:
            if not stacks.get(key):
                errors.append(f"event #{i}: 'E' with no open 'B' on "
                              f"pid/tid {key}")
            else:
                stacks[key].pop()
        elif ph == PH_COMPLETE:
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event #{i}: 'X' needs a dur >= 0, "
                              f"got {dur!r}")
        elif ph == PH_COUNTER:
            args = ev.get("args") or {}
            if not any(isinstance(v, (int, float))
                       for v in args.values()):
                errors.append(f"event #{i}: counter with no numeric args")
        elif ph in (PH_ASYNC_BEGIN, PH_ASYNC_END):
            if "id" not in ev:
                errors.append(f"event #{i}: async event missing 'id'")
            akey = (ev.get("cat", ""), ev.get("id"))
            delta = 1 if ph == PH_ASYNC_BEGIN else -1
            async_open[akey] = async_open.get(akey, 0) + delta
            if async_open[akey] < 0:
                errors.append(f"event #{i}: async 'e' before 'b' for "
                              f"{akey}")
    for key, stack in stacks.items():
        for name in stack:
            errors.append(f"span '{name}' on pid/tid {key} never closed")
    return errors


def page_events_from_chrome(doc: Dict[str, Any]):
    """Rebuild the `analysis.events` PageEvent stream from an exported
    trace (the bridge's inverse). The result replays through
    `analysis.sanitizer.LifecycleChecker` exactly like the pool's own
    trace — the round-trip tests assert the two agree."""
    from repro_torch.analysis.events import EventKind, PageEvent
    out = []
    for ev in doc.get("traceEvents", ()):
        if ev.get("cat") != "page" or ev.get("ph") != PH_INSTANT:
            continue
        args = dict(ev.get("args") or {})
        kind = EventKind(ev["name"])
        shared_key = args.get("shared_key")
        if isinstance(shared_key, list):
            shared_key = tuple(
                tuple(x) if isinstance(x, list) else x for x in shared_key)
        out.append(PageEvent(
            seq=int(args["seq"]),
            clock=int(args["clock"]),
            kind=kind,
            pid=args.get("page"),
            frame=args.get("frame"),
            refcount=args.get("refcount"),
            deadline=(None if args.get("deadline") is None
                      else float(_json_restore(args["deadline"]))),
            cause=args.get("cause"),
            pinned=tuple(args.get("pinned") or ()),
            frames=tuple(args.get("frames") or ()),
            n_valid=args.get("n_valid"),
            shared_key=shared_key,
        ))
    out.sort(key=lambda e: e.seq)
    return out
