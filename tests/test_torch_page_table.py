"""The paged engine's page table kept across ticks, on the CPU (reduced
qwen3, the port's plain kernels).

With the pool's trace off a decode tick reads its page table from rows the
engine keeps up to date as pages change, instead of walking every page. Each
live slot's kept row must equal a rebuild from its pages after every step
of the serving scripts (prefix sharing, first-token replay, preempt and
resume through the cold tier, chunked prefill, finishes, and steals from a
small hot tier), and tokens and ``PoolMetrics`` must equal a run with the
trace on, which walks every page as the reference does. A steady tick
rewrites no row and calls none of the pool's per-page methods;
``gauges/page_rows_rebuilt`` counts the rows rewritten on admission and
after a restore.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.analysis.events import EventKind
from repro_torch.configs import get_config
from repro_torch.core.pul import Direction
from repro_torch.models import init_params
from repro_torch.obs.tracer import Tracer
from repro_torch.serving import (
    KVPagePool,
    PackedKVLayout,
    PageConfig,
    PagedEngineConfig,
    PagedServingEngine,
    Request,
)
from repro_torch.serving.kv_pages import ZERO_FRAME
from test_torch_serving import SCRIPTS

BASE = dict(batch_slots=2, max_seq=64, page_tokens=8,
            prefill_buckets=(8, 16, 32), device="cpu")
PATHS = {"sweep": dict(use_paged_kernel=True, sweep_decode=True),
         "per-layer": dict(use_paged_kernel=True, sweep_decode=False),
         "assembly": dict(use_paged_kernel=False)}


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 256, size=n).tolist()


def _script_steals(eng, Req):
    """r1 shares r0's first prompt page; a high-priority arrival swaps r0
    out and r1 finishes, so the shared page stays hot but no slot holds it.
    The arrival's tail pages then fill the hot tier and steal that page,
    and r0 comes back through the cold tier."""
    p0 = _prompt(5, 16)
    eng.submit(Req(rid=0, prompt=list(p0), max_new_tokens=6))
    eng.submit(Req(rid=1, prompt=p0[:8] + _prompt(6, 8), max_new_tokens=3))
    eng.step()
    eng.submit(Req(rid=2, prompt=_prompt(7, 24), max_new_tokens=24,
                   priority=5))
    return eng.run()


#: script -> (its function, engine settings): test_torch_serving's and the steals
SCRIPTS = {**SCRIPTS,
           "steals": (_script_steals, dict(policy="priority", hot_pages=6))}
#: (script, path)
CASES = {
    "fcfs-sweep": ("fcfs", "sweep"),
    "fcfs-per-layer": ("fcfs", "per-layer"),
    "fcfs-assembly": ("fcfs", "assembly"),
    "priority+chunked-sweep": ("priority+chunked", "sweep"),
    "priority+chunked-per-layer": ("priority+chunked", "per-layer"),
    "steals-sweep": ("steals", "sweep"),
    "steals-per-layer": ("steals", "per-layer"),
}


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen3-1.7b").reduced()
    return cfg, init_params(cfg, seed=0, device="cpu")


def _engine(model, path="sweep", tracer=None, **kw):
    cfg, params = model
    return PagedServingEngine(cfg, params, PagedEngineConfig(
        **{**BASE, **PATHS[path], **kw}), tracer=tracer)


def _rebuilt_row(eng, slot):
    row = np.full((eng.n_pages_per_slot,), ZERO_FRAME, np.int32)
    pids = eng.slot_pages[slot]
    row[:len(pids)] = [eng.pool.pages[p].frame for p in pids]
    return row


def _check_rows(eng):
    for i in eng._live_slots():
        np.testing.assert_array_equal(eng._page_table[i],
                                      _rebuilt_row(eng, i), f"slot {i}")


def _drive(eng, script, after_step=None):
    """`script` of test_torch_serving on `eng`, `after_step(eng)` after
    every step; returns {rid: tokens}."""
    if after_step is not None:
        step = eng.step

        def checked():
            step()
            after_step(eng)

        eng.step = checked
    drive, _ = SCRIPTS[script]
    return drive(eng, Request)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kept_rows_equal_a_rebuild_after_every_step(model, case):
    script, path = CASES[case]
    kw = SCRIPTS[script][1]
    off = _engine(model, path, **kw)
    assert off.pool.trace is None
    got = _drive(off, script, after_step=_check_rows)

    on = _engine(model, path, shadow_check=True, **kw)
    assert _drive(on, script, after_step=_check_rows) == got
    assert dataclasses.asdict(off.pool.metrics) == \
        dataclasses.asdict(on.pool.metrics)
    pm = off.pool.metrics
    assert pm.page_faults >= 1 and pm.useful_preloads >= 1
    pm.validate()
    causes = {e.cause for e in on.pool.trace.events
              if e.kind is EventKind.EVICT}
    assert ("steal" in causes) == (script == "steals")


class _Calls:
    """Counts the engine's calls of the pool's per-page methods."""

    def __init__(self, monkeypatch):
        self.n = {"frames_of": 0, "ensure_hot": 0}
        for name in self.n:
            method = getattr(KVPagePool, name)

            def counted(pool, *a, _name=name, _method=method, **kw):
                self.n[_name] += 1
                return _method(pool, *a, **kw)

            monkeypatch.setattr(KVPagePool, name, counted)


def _rebuilt(tracer):
    """Each decode tick's ``gauges/page_rows_rebuilt``, in order."""
    return [e.args["value"] for e in tracer.events
            if e.ph == "C" and e.track == "gauges"
            and e.name == "page_rows_rebuilt"]


def test_steady_tick_rewrites_no_row_and_walks_no_page(model, monkeypatch):
    calls = _Calls(monkeypatch)
    tracer = Tracer()
    eng = _engine(model, tracer=tracer, batch_slots=3, max_seq=128)
    for rid in range(2):
        eng.submit(Request(rid=rid, prompt=_prompt(rid, 12 + 4 * rid),
                           max_new_tokens=60))
    eng.step()                                  # two admissions
    assert _rebuilt(tracer) == [2]
    for _ in range(20):                         # tail pages, no admission
        eng.step()
        _check_rows(eng)
    assert _rebuilt(tracer)[1:] == [0] * 20
    assert calls.n == {"frames_of": 0, "ensure_hot": 0}

    eng.submit(Request(rid=2, prompt=_prompt(2, 20), max_new_tokens=40))
    eng.step()
    assert _rebuilt(tracer)[-1] == 1            # one admission
    eng.preempt(0)
    eng.step()                                  # slot 0's pages go cold
    assert _rebuilt(tracer)[-1] == 0
    eng.resume(0)
    faults = eng.pool.metrics.page_faults
    eng.step()                                  # restored: one row moved
    assert eng.pool.metrics.page_faults > faults
    assert _rebuilt(tracer)[-1] == 1
    _check_rows(eng)
    eng.step()
    assert _rebuilt(tracer)[-1] == 0
    assert calls.n == {"frames_of": 0, "ensure_hot": 0}


def test_traced_tick_touches_and_reads_every_page(model):
    """With the trace on, every tick TOUCHes each live page once and READs
    each page of each live row, as the reference's walk does."""
    eng = _engine(model, shadow_check=True, batch_slots=3, max_seq=128)
    p0 = _prompt(0, 16)
    eng.submit(Request(rid=0, prompt=list(p0), max_new_tokens=30))
    eng.submit(Request(rid=1, prompt=p0[:8] + _prompt(1, 8),
                       max_new_tokens=30))     # shares the first page
    for _ in range(12):
        seen = len(eng.pool.trace.events)
        eng.step()
        fresh = eng.pool.trace.events[seen:]
        live = eng._live_slots()
        rows = [p for i in live for p in eng.slot_pages[i]]
        touched = [e.pid for e in fresh
                   if e.kind is EventKind.TOUCH]
        read = [e.pid for e in fresh if e.kind is EventKind.READ]
        assert touched == sorted(set(rows))
        assert read == rows
    assert eng.pool.metrics.shared_hits >= 1


def _tick(pool, needed, walked):
    """One decode tick's residency and read of the pages `needed`: the
    reference's walk, or the untraced tick's pool methods. Returns their
    frames."""
    pids = sorted(needed)
    if walked:
        pool.ensure_hot(pids)
        return pool.frames_of(pids)
    pool.restore_cold(lambda: set(needed))
    frames = np.array([pool.pages[p].frame for p in pids], np.int32)
    pool.touch_frames(frames)
    pool.note_reads(frames)
    return frames


def test_untraced_tick_leaves_the_walks_lru_order_and_counts(model):
    """restore_cold, touch_frames and note_reads leave the frames, the
    eviction order and PoolMetrics of ensure_hot and frames_of."""
    cfg = dataclasses.replace(model[0], paged_kv=True)
    seen = {}
    for walked in (True, False):
        pool = KVPagePool(PageConfig(page_tokens=8, hot_frames=6),
                          layout=PackedKVLayout(cfg, 1, 16), device="cpu")
        a, b, c, d = (pool.alloc() for _ in range(4))   # every frame
        pool.evict(a)
        frames = [_tick(pool, {a, b}, walked).tolist(),  # restores a
                  _tick(pool, {c}, walked).tolist()]
        pool.alloc()                # steals the least recently used: d
        pool.alloc()                # then a, touched with b, lower id
        unloads = [t.tag for t in pool.metrics.descriptors
                   if t.direction is Direction.UNLOAD]
        assert unloads == [a, d, a]
        assert pool.metrics.useful_preloads == 1
        seen[walked] = (frames, dataclasses.asdict(pool.metrics))
    assert seen[True] == seen[False]
