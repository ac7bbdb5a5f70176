"""The port's tracing of the paged decode step, on the CPU (reduced qwen3,
the port's plain kernels; no JAX).

With a recording ``Tracer`` each decode tick's ``engine/decode`` span holds
the five phase spans in order; a captured step's timer puts one
``device/decode_step`` span and one ``gauges/device_step_ms`` value a tick
on the tracer's clock (a fake timer stands in for the card's CUDA events).
With tracing off the pool emits no per-page event and the engine makes no
timer, and tokens and counters equal the traced run's. The pool's count of
hot pages equals a recount after every step of a run that preempts, evicts
and restores, and the pool's tracer bridge rebuilds exactly the state
changes of its ``TraceLog``.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.analysis.events import STATE_KINDS, EventKind
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.obs.tracer import (
    NULL_TRACER,
    Tracer,
    page_events_from_chrome,
    validate_chrome_trace,
)
from repro_torch.serving import (
    KVPagePool,
    PagedEngineConfig,
    PagedServingEngine,
    Request,
)

PHASES = ["decode_pages", "decode_fill", "decode_launch", "decode_wait",
          "decode_emit"]
PATHS = {"sweep": dict(use_paged_kernel=True, sweep_decode=True),
         "per-layer": dict(use_paged_kernel=True, sweep_decode=False),
         "assembly": dict(use_paged_kernel=False)}
BASE = dict(batch_slots=2, max_seq=64, page_tokens=8,
            prefill_buckets=(8, 16, 32), device="cpu")
#: the fake timer's device time of every step, µs
STEP_US = 3.0


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen3-1.7b").reduced()
    return cfg, init_params(cfg, seed=0, device="cpu")


def _engine(model, tracer=None, path="sweep", **kw):
    cfg, params = model
    return PagedServingEngine(cfg, params, PagedEngineConfig(
        **{**BASE, **PATHS[path], **kw}), tracer=tracer)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 256, size=n).tolist()


def _script(eng, after_step=None):
    """Prefix sharing (r0/r1 share a page), a preempt/resume through the
    cold tier and a priority arrival that swaps a slot out; `after_step`
    runs after every step. Returns {rid: tokens}."""
    def step():
        eng.step()
        if after_step is not None:
            after_step(eng)

    p0 = _prompt(5, 16)
    eng.submit(Request(rid=0, prompt=list(p0), max_new_tokens=10))
    eng.submit(Request(rid=1, prompt=p0[:8] + _prompt(6, 4),
                       max_new_tokens=3))
    eng.submit(Request(rid=2, prompt=_prompt(7, 20), max_new_tokens=5))
    for _ in range(2):
        step()
    eng.preempt(0)
    for _ in range(2):
        step()
    eng.resume(0)
    step()
    eng.submit(Request(rid=3, prompt=_prompt(8, 5), max_new_tokens=4,
                       priority=5))
    while eng.pending():
        step()
    return {r.rid: list(r.out_tokens) for r in eng.requests.values()}


def _tree(tracer):
    """The engine track's synchronous spans as (name, start, end,
    children), nested as recorded."""
    root, stack = [], []
    for e in tracer.events:
        if e.track != "engine" or e.ph not in ("B", "E"):
            continue
        if e.ph == "B":
            node = [e.name, e.ts, None, []]
            (stack[-1][3] if stack else root).append(node)
            stack.append(node)
        else:
            stack.pop()[2] = e.ts
    assert not stack
    return root


def _decode_spans(tracer):
    return [n for tick in _tree(tracer) if tick[0] == "tick"
            for n in tick[3] if n[0] == "decode"]


def _snapshot(eng):
    snap = eng.snapshot()
    snap.pop("tokens_per_sec")          # the host's wall clock
    return snap


@pytest.mark.parametrize("path", sorted(PATHS))
def test_decode_tick_holds_the_five_phases_in_order(model, path):
    tracer = Tracer()
    eng = _engine(model, tracer, path, policy="priority")
    _script(eng)
    assert validate_chrome_trace(tracer.to_chrome()) == []
    decodes = _decode_spans(tracer)
    stepped = [d for d in decodes if d[3]]
    assert len(stepped) == eng.metrics.decode_steps > 0
    for name, t0, t1, children in stepped:
        assert [c[0] for c in children] == PHASES
        assert all(not c[3] for c in children)      # phases hold no spans
        edges = [t0] + [t for c in children for t in c[1:3]] + [t1]
        assert edges == sorted(edges)
    # a tick without a live slot opens no phase
    assert all(not d[3] for d in decodes if d not in stepped)
    # the CPU makes no timer, so no device span
    assert eng._step_timer is None
    assert not any(e.track == "device" for e in tracer.events)


class _FakeTimer:
    """A ``serving.capture.StepTimer`` without a card: the step starts
    where the host begins it, on the tracer's clock, and takes STEP_US; the
    second anchor check reports a drift."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.anchor_us = tracer.now_us()
        self.since_anchor_us = None
        self.checks = 0

    def begin(self):
        self.since_anchor_us = self.tracer.now_us() - self.anchor_us

    def end(self):
        pass

    def span_us(self):
        return self.anchor_us + self.since_anchor_us, STEP_US

    def reanchor_if_due(self):
        self.checks += 1
        return 0.5 if self.checks == 2 else None


class _FakeCaptured:
    """A captured step that runs the engine's device half eagerly between
    its timer's events."""

    def __init__(self, eng, timer):
        self.eng, self.timer = eng, timer

    def replay(self, planes):
        assert planes.keys() == self.eng._updated().keys()
        self.timer.begin()
        out = self.eng._device_step()
        self.timer.end()
        return out


@pytest.mark.parametrize("path", ["sweep", "per-layer"])
def test_timed_step_gives_a_device_span_inside_each_tick(model, path):
    tracer = Tracer()
    eng = _engine(model, tracer, path, policy="priority")
    timer = _FakeTimer(tracer)
    eng._step_timer = timer
    eng._captured = _FakeCaptured(eng, timer)
    got = _script(eng)
    assert got == _script(_engine(model, path=path, policy="priority"))

    stepped = [d for d in _decode_spans(tracer) if d[3]]
    device = [e for e in tracer.events if e.track == "device"]
    gauges = [e.args["value"] for e in tracer.events
              if e.track == "gauges" and e.name == "device_step_ms"]
    drifts = [e.args["value"] for e in tracer.events
              if e.name == "device_clock_drift_us"]
    assert len(device) == len(gauges) == len(stepped) > 0
    assert gauges == [STEP_US / 1e3] * len(stepped) and drifts == [0.5]
    for ev, (_, _, _, phases) in zip(device, stepped):
        assert (ev.ph, ev.name, ev.dur) == ("X", "decode_step", STEP_US)
        launch, wait = phases[2], phases[3]
        assert launch[1] <= ev.ts and ev.ts + ev.dur <= wait[2]
    assert validate_chrome_trace(tracer.to_chrome()) == []


class _Spy:
    """Counts the kinds a pool's ``_emit`` is called with."""

    def __init__(self, monkeypatch):
        self.kinds = []
        emit = KVPagePool._emit

        def spy(pool, kind, **fields):
            self.kinds.append(kind)
            emit(pool, kind, **fields)

        monkeypatch.setattr(KVPagePool, "_emit", spy)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_tracing_off_emits_no_per_step_event(model, path, monkeypatch):
    spy = _Spy(monkeypatch)
    off = _engine(model, NULL_TRACER, path, policy="priority")
    got = _script(off)
    per_step = {EventKind.TICK, EventKind.TOUCH, EventKind.READ,
                EventKind.WRITE_ROWS}
    assert spy.kinds and not per_step & set(spy.kinds)
    assert off.pool.metrics.evictions >= 1
    assert off.pool.metrics.page_faults >= 1
    assert off._step_timer is None

    spy.kinds.clear()
    tracer = Tracer()
    on = _engine(model, tracer, path, policy="priority")
    assert _script(on) == got
    assert not per_step & set(spy.kinds)    # the tracer takes none of them
    assert _snapshot(on) == _snapshot(off)
    assert dataclasses.asdict(on.pool.metrics) == \
        dataclasses.asdict(off.pool.metrics)

    spy.kinds.clear()
    shadow = _engine(model, tracer=None, path=path, policy="priority",
                     shadow_check=True)
    assert _script(shadow) == got
    assert per_step <= set(spy.kinds)
    assert _snapshot(shadow) == _snapshot(off)


def _recount(eng):
    pool = eng.pool
    assert pool.hot_in_use() == sum(
        1 for m in pool.pages.values() if m.frame is not None)


@pytest.mark.parametrize("hot_pages", [0, 8], ids=["default-pool", "small-pool"])
def test_hot_count_equals_a_recount_after_every_step(model, hot_pages):
    eng = _engine(model, policy="priority", hot_pages=hot_pages)
    _script(eng, after_step=_recount)
    pm = eng.pool.metrics
    assert pm.evictions >= 1 and pm.page_faults >= 1
    assert eng.metrics.preemptions >= 1
    assert eng.pool.hot_in_use() == 0 == eng.snapshot()["hot_pages_in_use"]


@pytest.mark.parametrize("shadow", [True, False], ids=["shadow", "bridge"])
def test_bridge_rebuilds_the_logs_state_changes(model, shadow):
    tracer = Tracer()
    eng = _engine(model, tracer, policy="priority", hot_pages=6,
                  shadow_check=shadow)
    _script(eng)
    rebuilt = page_events_from_chrome(tracer.to_chrome())
    assert {e.kind for e in rebuilt} <= STATE_KINDS
    assert {EventKind.EVICT, EventKind.RESTORE} <= {e.kind for e in rebuilt}
    log = _engine(model, policy="priority", hot_pages=6, shadow_check=True)
    _script(log)
    want = [e for e in log.pool.trace.events if e.kind in STATE_KINDS]
    if shadow:
        assert rebuilt == want
    else:                   # the bridge numbers its own events
        assert [e.seq for e in rebuilt] == list(range(len(rebuilt)))
        assert rebuilt == [dataclasses.replace(e, seq=i)
                           for i, e in enumerate(want)]
