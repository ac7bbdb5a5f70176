"""Reading a traced run: the engine's host spans and counters (the port's
``obs.tracer``), and the device's kernels from ``torch.profiler`` over a
short profiled slice, with each engine span mirrored into the profiler's
timeline so that an idle gap on the device can be named by what the host
was doing.

Busy time is the measure of the union of the device's activity intervals
(kernels, copies, sets), so kernels that overlap are counted once.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

#: the profiled slice's own annotation
WINDOW = "pulbench/profiled"
#: what the host is doing when no engine span is open
OUTSIDE = "harness (between engine steps)"
#: the port's paged decode kernels (K1/K2 in pul_paged_decode.cu, K3/K4 in
#: pul_paged_mla_decode.cu): their split and merge kernels, not K6's
#: decode_split/decode_merge
PAGED_DECODE = re.compile(r"(?<!\w)(split|merge)_kernel\b")


def mirror_tracer():
    """A port ``Tracer`` whose synchronous spans also open a
    ``torch.profiler.record_function`` range of the same name while
    ``mirror`` is set (outside a profiler the range records nothing)."""
    from repro_torch.obs.tracer import Tracer

    class MirrorTracer(Tracer):
        def __init__(self):
            super().__init__()
            self.mirror = False
            self._open: List = []

        def begin_span(self, track, name, **args):
            super().begin_span(track, name, **args)
            if self.mirror:
                rf = torch.profiler.record_function(f"{track}/{name}")
                rf.__enter__()
                self._open.append(rf)

        def end_span(self, track, name=""):
            if self.mirror and self._open:
                self._open.pop().__exit__(None, None, None)
            super().end_span(track, name)

    return MirrorTracer()


@dataclasses.dataclass
class HostSpans:
    """The tracer's synchronous spans and counters, on the host clock
    (``time.perf_counter`` seconds)."""

    spans: List[Tuple[str, float, float]]
    counters: Dict[str, List[Tuple[float, float]]]


def host_spans(tracer) -> HostSpans:
    t0 = tracer._t0
    spans, stack = [], []
    counters: Dict[str, List[Tuple[float, float]]] = {}
    for e in tracer.events:
        ts = t0 + e.ts / 1e6
        if e.ph == "B":
            stack.append((f"{e.track}/{e.name}", ts))
        elif e.ph == "E" and stack:
            name, start = stack.pop()
            spans.append((name, start, ts))
        elif e.ph == "C":
            counters.setdefault(f"{e.track}/{e.name}", []).append(
                (ts, float(e.args["value"])))
    return HostSpans(spans, counters)


@dataclasses.dataclass
class DeviceTrace:
    """One profiled slice: its bounds and every device activity and
    mirrored host span in it (ns on the profiler's clock)."""

    start: int
    end: int
    device: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        ivs = sorted((s, e) for _, s, e in self.device)
        out: List[List[int]] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds_of(self, pattern: re.Pattern) -> Tuple[float, int]:
        """(device seconds, launches) of the activities whose name matches."""
        hits = [(s, e) for n, s, e in self.device if pattern.search(n)]
        return sum(e - s for s, e in hits) / 1e9, len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, int] = {}
        for name, s, e in self.device:
            key = name[:160]
            total[key] = total.get(key, 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Idle device seconds, by the innermost engine span open at each
        gap's midpoint (OUTSIDE where none is)."""
        busy = self.busy_intervals()
        gaps, last = [], self.start
        for s, e in busy:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if self.end > last:
            gaps.append((last, self.end))
        spans = sorted(self.host, key=lambda x: x[1])
        starts = [s for _, s, _ in spans]
        total: Dict[str, int] = {}
        for a, b in gaps:
            m = (a + b) // 2
            i = bisect.bisect_right(starts, m)
            inner: Optional[Tuple[str, int, int]] = None
            # spans nest within a tick: look back over the few before m
            for name, s, e in reversed(spans[max(0, i - 64):i]):
                shorter = inner is None or e - s < inner[2] - inner[1]
                if s <= m < e and shorter:
                    inner = (name, s, e)
            key = inner[0] if inner else OUTSIDE
            total[key] = total.get(key, 0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


def profile_slice(step: Callable[[], None], seconds: float,
                  tracer) -> DeviceTrace:
    """Run `step` under ``torch.profiler`` for `seconds` (whole steps), the
    tracer's spans mirrored into the profiler's timeline."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    tracer.mirror = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    step()
                torch.cuda.synchronize()
    finally:
        tracer.mirror = False
    return _read(prof)


def _read(prof) -> DeviceTrace:
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    start = end = None
    device, host = [], []
    for e in events:
        name = e.name()
        s = e.start_ns()
        f = s + e.duration_ns()
        annotation = name == WINDOW or name.startswith("engine/")
        if e.device_type() == cuda:
            if not annotation:     # the ranges' own copies on the device
                device.append((name, s, f))
        elif name == WINDOW:
            start, end = s, f
        elif annotation:
            host.append((name, s, f))
    if start is None:
        raise RuntimeError("the profiler recorded no profiled window")
    device = [(n, max(s, start), min(f, end)) for n, s, f in device
              if f > start and s < end]
    return DeviceTrace(start, end, device, host)
