"""The readers of the decode step's phase spans and device time, on the
CPU: a traced tiny run of each cell reports the page walk and the emit
phase; the device time and the idle share it gives read only where a step
timer records, which the CPU has not, so a fake timer stands in for the
card's CUDA events; and on a made-up run each reader gives the number its
definition says."""
import time

import pytest

from pulbench import harness, spec
from pulbench.tests.tiny import tiny_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 33
STEP_MS = 0.004
HOST = ["page_walk_ms_p50", "emit_ms_p50"]
DEVICE = ["device_step_ms_p50", "decode_idle_share"]


class _FakeTimer:
    """Each step starts where the host begins it and takes STEP_MS."""

    def __init__(self, tracer):
        self.tracer, self.anchor_us, self.at = tracer, tracer.now_us(), 0.0

    def begin(self):
        self.at = self.tracer.now_us() - self.anchor_us

    def end(self):
        pass

    def span_us(self):
        return self.anchor_us + self.at, STEP_MS * 1e3

    def reanchor_if_due(self):
        return None


class _FakeCaptured:
    def __init__(self, engine, timer):
        self.engine, self.timer = engine, timer

    def replay(self, planes):
        self.timer.begin()
        out = self.engine._device_step()
        self.timer.end()
        return out


def _timed(engine):
    engine._step_timer = _FakeTimer(engine.tracer)
    engine._captured = _FakeCaptured(engine, engine._step_timer)


def _metrics(cell, break_path=None):
    out = harness.run_cell(tiny_cell(cell), SEED, 0.0, True, "cpu",
                           time.perf_counter(), break_path=break_path)
    return {k: v["value"] for k, v in out.line()["metrics"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_phases(cell):
    got = _metrics(cell)
    for name in HOST:
        assert name in {m["name"] for m in spec.cell(cell).per_layer}
        assert got[name] > 0
    assert not set(DEVICE) & set(got)     # no timer on the CPU


@pytest.mark.parametrize("cell", CELLS)
def test_step_timer_gives_device_time_and_idle_share(cell):
    got = _metrics(cell, break_path=_timed)
    assert got["device_step_ms_p50"] == pytest.approx(STEP_MS)
    assert 0 < got["decode_idle_share"] < 100


def _run(ticks, spans, counters):
    return harness.Run(arch=None, peaks=None, window_s=1.0, ticks=ticks,
                       spans=spans, counters=counters, pool_capacity=1)


def test_readers_on_a_made_up_run():
    ticks = [harness.Tick(0.0, 1.0, "window"), harness.Tick(1.0, 2.0, "window"),
             harness.Tick(2.0, 3.0, "window")]
    spans = [("engine/decode", 0.1, 0.9), ("engine/decode_pages", 0.1, 0.2),
             ("engine/decode_fill", 0.2, 0.25), ("engine/decode_emit", 0.8, 0.9),
             ("engine/decode", 1.1, 1.5), ("engine/decode_pages", 1.1, 1.4),
             ("engine/decode_fill", 1.4, 1.45), ("engine/decode_emit", 1.4, 1.5),
             # a tick whose decode had no live slot: no phases
             ("engine/decode", 2.1, 2.1)]
    run = _run(ticks, spans, {"gauges/device_step_ms": [300.0, 100.0]})
    read = spec.metric_reader
    assert read("page_walk_ms_p50")(run) == pytest.approx(250.0)
    assert read("emit_ms_p50")(run) == pytest.approx(100.0)
    assert read("device_step_ms_p50")(run) == pytest.approx(200.0)
    assert read("decode_idle_share")(run) == pytest.approx(
        100 * (1 - 0.4 / 1.2))
    empty = _run(ticks, [], {})
    assert all(read(name)(empty) is None for name in HOST + DEVICE)
