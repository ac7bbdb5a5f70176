"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the plain reference, and the result's numbers.

The window drives ``repro_torch.serving.engine.PagedServingEngine`` through
``submit`` and ``step`` on its default path (the captured sweep, K1),
greedy, ``fcfs``. The harness times each step on
the host clock (a step ends in a synchronising copy of the logits) and
stamps every token a step emitted with the step's end.

``run_cell`` takes a device, so the CPU tests drive all of it at a reduced
size with the port's plain kernels; ``run.py`` refuses anything but CUDA.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import os
import resource
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from pulbench import arith, spec, traffic as T, weights as W
from pulbench.reference import common as R

#: steps after the sessions' prefill and before the window (the first
#: decode step captures the graph)
WARM_STEPS = 3
#: seconds of the traced slice that follows the window under torch.profiler
PROFILE_SECONDS = 2.0
#: steps a window holds at least, whatever its seconds (a gap between two
#: tokens needs two)
MIN_WINDOW_STEPS = 2
#: seconds past the window's close that requests may take to get their
#: first token
DRAIN_SECONDS = 60.0


@dataclasses.dataclass
class Tick:
    """One engine step as the harness saw it."""

    t0: float
    t1: float
    phase: str                          # setup | window | profiled | drain
    tokens: int = 0                     # tokens the step emitted
    decode: List[int] = dataclasses.field(default_factory=list)
    prefill: List[int] = dataclasses.field(default_factory=list)
    span_s: Optional[float] = None      # the engine/tick span, traced runs


@dataclasses.dataclass
class Tracked:
    """A request from the harness's side."""

    req: Any
    prompt_len: int
    submit_t: float
    phase: str
    times: List[float] = dataclasses.field(default_factory=list)

    @property
    def first_t(self) -> Optional[float]:
        return self.times[0] if self.times else None


class Driver:
    """Submits the traffic's requests and steps the engine, recording each
    step's work and each token's time."""

    def __init__(self, engine, request_cls):
        self.engine = engine
        self.request_cls = request_cls
        self.all: Dict[int, Tracked] = {}
        self.live: Dict[int, Tracked] = {}
        self.ticks: List[Tick] = []
        self._rid = 0
        self.on_done: Optional[Callable[[Tracked], None]] = None

    def submit(self, draw: T.Draw, phase: str) -> Tracked:
        req = self.request_cls(rid=self._rid, prompt=list(draw.prompt),
                               max_new_tokens=draw.max_new_tokens)
        self._rid += 1
        tr = Tracked(req, len(draw.prompt), time.perf_counter(), phase)
        self.engine.submit(req)
        self.all[req.rid] = self.live[req.rid] = tr
        return tr

    def step(self, phase: str) -> Tick:
        before = {rid: len(tr.req.out_tokens) for rid, tr in self.live.items()}
        t0 = time.perf_counter()
        self.engine.step()
        t1 = time.perf_counter()
        tick = Tick(t0, t1, phase)
        done = []
        for rid, tr in self.live.items():
            a, b = before[rid], len(tr.req.out_tokens)
            if b > a:
                tr.times.extend([t1] * (b - a))
                tick.tokens += b - a
                if a == 0:
                    tick.prefill.append(tr.prompt_len)
                    tick.decode.extend([tr.prompt_len] * (b - 1))
                else:
                    tick.decode.extend(tr.prompt_len + a - 1 + i
                                       for i in range(b - a))
            if tr.req.done:
                done.append(rid)
        self.ticks.append(tick)
        for rid in done:
            tr = self.live.pop(rid)
            if self.on_done is not None:
                self.on_done(tr)
        return tick


def _engine(cell: spec.Cell, tree, device, tracer):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serving.engine import (PagedEngineConfig,
                                            PagedServingEngine)
    eng = cell.traffic["engine"]
    ecfg = PagedEngineConfig(
        batch_slots=eng["batch_slots"], max_seq=eng["max_seq"],
        page_tokens=eng["page_tokens"],
        prefill_buckets=tuple(eng["prefill_buckets"]),
        prefill_chunk_tokens=eng["prefill_chunk_tokens"],
        share_prefix_pages=eng["share_prefix_pages"],
        hot_pages=eng.get("hot_pages", 0), policy="fcfs",
        greedy=True, device=str(device))
    return PagedServingEngine(ModelConfig(**spec.port_config(cell.config)),
                              tree, ecfg, tracer=tracer)


# ------------------------------------------------------------------------ #
# set-up and window of each mode
# ------------------------------------------------------------------------ #
def _steal_s() -> float:
    """CPU seconds the hypervisor gave to others, summed over this
    machine's CPUs (``/proc/stat``; 0 where it is not readable)."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


def _host_use() -> List[float]:
    """This thread's user and system CPU seconds, its involuntary context
    switches, the machine's stolen CPU seconds, and the collections of each
    garbage-collector generation."""
    r = resource.getrusage(getattr(resource, "RUSAGE_THREAD",
                                   resource.RUSAGE_SELF))
    return [r.ru_utime, r.ru_stime, r.ru_nivcsw, _steal_s()] + [
        g["collections"] for g in gc.get_stats()]


def _window(drv: Driver, seconds: float) -> float:
    """Whole steps for `seconds` (MIN_WINDOW_STEPS at least); returns the
    window's start. Logs what the host did meanwhile."""
    use = _host_use()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds or n < MIN_WINDOW_STEPS:
        drv.step("window")
        n += 1
    spent = [b - a for a, b in zip(use, _host_use())]
    ms = np.sort([(t.t1 - t.t0) * 1e3 for t in drv.ticks[-n:]])
    log(f"window: {n} steps, step ms p10 {ms[n // 10]:.2f} p50 "
        f"{ms[n // 2]:.2f} p90 {ms[n * 9 // 10]:.2f} max {ms[-1]:.2f}; "
        f"main thread {spent[0]:.2f} s user {spent[1]:.2f} s system, "
        f"{spent[2]:.0f} involuntary switches; {spent[3]:.2f} CPU s stolen "
        f"by the hypervisor; gc collections {[int(x) for x in spent[4:]]}")
    return t0


def _closed_batch(drv: Driver, mix, draws: List[T.Draw], seconds: float,
                  profile: Optional[Callable]) -> float:
    """Sessions submitted `admit_per_step` a step and prefilled in set-up,
    WARM_STEPS more steps, then the window; returns its start."""
    k = mix["admit_per_step"]
    for lo in range(0, len(draws), k):
        for d in draws[lo:lo + k]:
            drv.submit(d, "setup")
        drv.step("setup")
    log(f"set-up: {len(draws)} sessions prefilled")
    for _ in range(WARM_STEPS):
        drv.step("setup")
    t0 = _window(drv, seconds)
    if profile is not None:
        profile(lambda: drv.step("profiled"))
    return t0


def _closed_loop(drv: Driver, mix, stream, seconds: float,
                 profile: Optional[Callable], buckets) -> float:
    """Warm-up requests at every bucket, then `clients` callers with no
    think time until `warm_completions` requests have finished, then the
    window; returns its start. After it, no new request is sent and the
    engine steps until every request of the window has its first token."""
    for b in buckets:
        drv.submit(T.Draw(-1, [1] * b, 2), "warmup")
    while drv.live:
        drv.step("setup")
    state = {"phase": "setup", "completions": 0}

    def resubmit(tr: Tracked):
        if tr.phase == "warmup":
            return
        state["completions"] += 1
        if state["phase"] != "after":
            drv.submit(next(stream), state["phase"])

    drv.on_done = resubmit
    for _ in range(mix["clients"]):
        drv.submit(next(stream), "setup")
    log("set-up: warm-up requests done")
    while state["completions"] < mix["warm_completions"]:
        drv.step("setup")
    log(f"set-up: {state['completions']} requests completed")
    state["phase"] = "window"
    t0 = _window(drv, seconds)
    if profile is not None:
        state["phase"] = "profiled"
        profile(lambda: drv.step("profiled"))
    state["phase"] = "after"
    t_drain = time.perf_counter()
    while (any(tr.phase == "window" and not tr.times
               for tr in drv.live.values())
           and time.perf_counter() - t_drain < DRAIN_SECONDS):
        drv.step("drain")
    return t0


# ------------------------------------------------------------------------ #
# the comparison with the plain reference
# ------------------------------------------------------------------------ #
def _sample(trs: List[Tracked], k: int, seed: int) -> List[Tracked]:
    """k of `trs` drawn from the seed, the one with the most served tokens
    (then the longest prompt) always among them."""
    if len(trs) <= k:
        return trs
    longest = max(range(len(trs)), key=lambda i: (len(trs[i].req.out_tokens),
                                                   trs[i].prompt_len))
    rest = [i for i in range(len(trs)) if i != longest]
    pick = np.random.default_rng([int(seed), 4]).choice(rest, k - 1,
                                                        replace=False)
    return [trs[longest]] + [trs[i] for i in sorted(pick.tolist())]


def compare(a: spec.Arch, tree, mix, judged: List[Tracked],
            control: bool = False) -> Dict[str, float]:
    """The widest gap by which a served token's logit lies below the
    reference's best, over every served token of `judged`; with `control`,
    also the same for the token the fp8 control puts first at each of
    those positions. The reference is ``reference/<family>.py``."""
    from importlib import import_module
    ref = import_module(f"pulbench.reference.{a.family}")
    out: Dict[str, float] = {}
    with torch.no_grad(), R.fp32_exact():
        w = R.Weights(tree)
        requests = [(list(tr.req.prompt), list(tr.req.out_tokens))
                    for tr in judged]
        dev = w.leaf("embedding/table").device
        tokens = torch.as_tensor([t for _, s in requests for t in s],
                                 device=dev)
        h = ref.hidden(w, a, requests, mix)
        head = ref.head(w, a)
        gaps = R.head_gaps(h, head, a.vocab, tokens)
        out["logit_gap"] = float(gaps.max()) if gaps.numel() else math.inf
        out["compared_tokens"] = int(tokens.numel())
        if control:
            wc = R.Weights(tree, fp8=True)
            cg = R.head_gaps(h, head, a.vocab, None,
                             control_head=ref.head(wc, a),
                             control_hidden=ref.hidden(wc, a, requests, mix))
            out["control_logit_gap"] = (float(cg.max()) if cg.numel()
                                        else math.inf)
    return out


# ------------------------------------------------------------------------ #
# one run
# ------------------------------------------------------------------------ #
@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, Dict[str, Any]]
    device: Dict[str, Any]
    checks: Dict[str, Dict[str, float]]
    breakdown: Optional[Dict[str, Any]] = None
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)

    def line(self) -> Dict[str, Any]:
        """The result line's object, the compared numbers last; a number
        that is not finite (nothing to compare) is written as null."""
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = {k: {n: _finite(v) for n, v in c.items()}
                         for k, c in self.checks.items()}
        return out


def _finite(v):
    return None if isinstance(v, float) and not math.isfinite(v) else v


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads (``metrics/<name>.py``)."""

    arch: spec.Arch
    peaks: Optional[Dict[str, float]]
    window_s: float
    ticks: List[Tick]                   # the window's steps
    spans: List[Any]                    # (name, start, end) in the window
    counters: Dict[str, List[float]]    # counter values in the window
    pool_capacity: int
    device_trace: Any = None            # trace.DeviceTrace of the slice
    profiled_ticks: List[Tick] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    itl_s: List[float] = dataclasses.field(default_factory=list)


#: the process's start on the perf_counter clock, which log lines count from
_STARTED = [time.perf_counter()]


def log(msg: str) -> None:
    print(f"[pulbench {time.perf_counter() - _STARTED[0]:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return math.nan
    return float(np.percentile(np.asarray(xs, np.float64), q))


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: str, process_start: float,
             control: bool = False,
             break_path: Optional[Callable] = None) -> Outcome:
    """One run of `cell`. With `control`, the tokens that the fp8 control
    puts first stand in for the served ones in the comparison, which has to
    come out not correct. `break_path(engine)`, called before the first
    request, lets a test break the timed path underneath."""
    from pulbench import trace as TR
    from repro_torch.serving.scheduler import Request

    _STARTED[0] = process_start
    a = spec.arch(cell.config)
    mix = cell.traffic
    T.check(mix)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    tree = W.make(a, seed, dev)
    tracer = TR.mirror_tracer() if traced else None
    engine = _engine(cell, tree, dev, tracer)
    if traced:
        # engine spans and gauges only: the pool's page-lifecycle events
        # (one per page a tick reads) would cost more than the step
        from repro_torch.obs.tracer import NULL_TRACER
        engine.pool.tracer = NULL_TRACER
    log(f"weights and engine ({W.nbytes(a) / 1e9:.2f} GB of weights)")
    drv = Driver(engine, Request)
    traffic = T.Traffic(mix, seed, a.vocab)
    if break_path is not None:
        break_path(engine)
    profile = None
    dtrace: List[Any] = []
    if traced and cuda:
        profile = lambda step: dtrace.append(
            TR.profile_slice(step, PROFILE_SECONDS, tracer))
    log("set-up: traffic drawn")
    if mix["mode"] == "closed_batch":
        draws = traffic.sessions()
        t0 = _closed_batch(drv, mix, draws, seconds, profile)
    else:
        t0 = _closed_loop(drv, mix, traffic.stream(), seconds, profile,
                          mix["engine"]["prefill_buckets"])
    log(f"set-up, window and slice: {len(drv.ticks)} steps")
    window = [t for t in drv.ticks if t.phase == "window"]
    t_end = window[-1].t1
    window_s = t_end - t0
    setup_s = t0 - process_start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    pool_capacity = engine.pool.capacity

    # ---- end-to-end numbers
    tokens = sum(t.tokens for t in window)
    itl = []
    for tr in drv.all.values():
        ts = [x for x in tr.times if t0 < x <= t_end]
        itl.extend(np.diff(ts).tolist())
    if mix["mode"] == "closed_batch":
        subject = list(drv.all.values())
        failed = [tr for tr in subject
                  if tr.req.failed or not any(t0 < x <= t_end
                                              for x in tr.times)]
        ttft: List[float] = []
    else:
        subject = [tr for tr in drv.all.values() if tr.phase == "window"]
        failed = [tr for tr in subject if tr.req.failed or not tr.times]
        ttft = [tr.first_t - tr.submit_t for tr in subject if tr.times]
        ttft += [math.inf] * len(failed)
    e2e = {"output_tokens_per_s": tokens / window_s,
           "itl_p95_ms": _percentile(itl, 95) * 1e3,
           "ttft_p95_ms": _percentile(ttft, 95) * 1e3,
           "setup_s": setup_s}

    # ---- per-layer numbers (traced runs)
    breakdown = None
    device_info: Dict[str, Any] = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1, "memory_peak_bytes": int(peak)}
    layer_values: Dict[str, float] = {}
    if traced:
        hs = TR.host_spans(tracer)
        for t in drv.ticks:
            inside = [(n, s, e) for n, s, e in hs.spans
                      if s >= t.t0 and e <= t.t1]
            tick_spans = [e - s for n, s, e in inside if n == "engine/tick"]
            t.span_s = tick_spans[0] if tick_spans else None
        run = Run(
            arch=a,
            peaks=arith.peaks(device_info["kind"]), window_s=window_s,
            ticks=window,
            spans=[(n, s, e) for n, s, e in hs.spans
                   if s >= t0 and e <= t_end],
            counters={k: [v for ts, v in vals if t0 <= ts <= t_end]
                      for k, vals in hs.counters.items()},
            pool_capacity=pool_capacity,
            device_trace=dtrace[0] if dtrace else None,
            profiled_ticks=[t for t in drv.ticks if t.phase == "profiled"],
            ttft_s=ttft, itl_s=itl)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(run)
            if v is not None:
                layer_values[m["name"]] = v
        if run.device_trace is not None:
            dt = run.device_trace
            device_info["busy_s"] = dt.busy_s()
            device_info["window_s"] = dt.window_s
            breakdown = {"device_ops": dt.top_ops(),
                         "idle_gaps": dt.idle_by_host()}

    # ---- the comparison, once the program's state is freed
    judged_pool = (subject if mix["mode"] == "closed_batch" else
                   [tr for tr in subject if tr.req.done and not tr.req.failed])
    judged = _sample(judged_pool, mix["sample"], seed)
    del engine, drv.engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"window {window_s:.2f} s, {len(window)} steps; reference over "
        f"{len(judged)} requests")
    cmp = compare(a, tree, mix, judged, control=control) if judged else {
        "logit_gap": math.inf, "compared_tokens": 0}
    log("reference done")

    # ---- checks against the cell's limits; the control's tokens stand in
    # for the served ones where `control`
    lim = cell.limits
    gap = cmp["control_logit_gap"] if control else cmp["logit_gap"]
    if control:
        log(f"control: the program's own logit_gap {cmp['logit_gap']}")
    checks = {
        "logit_gap": {"value": gap,
                      "limit": lim["logit_gap"]["limit"]},
        "failed_requests": {"value": len(failed), "limit": 0},
        "compared_tokens": {"value": cmp["compared_tokens"],
                            "limit": lim["compared_tokens"]["limit"]},
    }
    correct = (math.isfinite(gap)
               and lim["logit_gap"]["limit"] is not None
               and gap <= lim["logit_gap"]["limit"]
               and not failed
               and cmp["compared_tokens"] >= lim["compared_tokens"]["limit"])
    if traced:
        metrics = {m["name"]: {"value": layer_values[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.per_layer if m["name"] in layer_values}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        if any(not math.isfinite(v["value"]) for v in metrics.values()):
            correct = False
    readings = {**cmp, **e2e}
    return Outcome(correct=correct, attempted=len(subject),
                   failed=len(failed), metrics=metrics, device=device_info,
                   checks=checks, breakdown=breakdown, readings=readings)
