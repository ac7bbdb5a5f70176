"""The port's lifecycle sanitizer, diff_fifo_occupancy and the engine's
shadow_check (repro_torch.analysis, repro_torch.serving) vs the reference's.

Every event sequence of tests/test_analysis_sanitizer.py (synthetic
traces, and the broken pool call sequences replayed on the port's pool)
goes through both packages' LifecycleCheckers, which must report the same
(rule, page, event) triples, and the ones the reference test expects. A
pool call sequence gives the same trace, event by event, on both
packages' pools. Reduced qwen3-1.7b
bridged from the reference's init serves the same script through both
engines with shadow_check on, on the sweep, per-layer and assembly paths
with a preempt/resume: the two traces are equal and clean under both
checkers (also at end of trace), and corruptions planted in the port's trace
are flagged alike. diff_fifo_occupancy reads the same divergences out of
the two packages' DMA twins.
"""
import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import EventKind as RefKind
from repro.analysis import LifecycleChecker as RefChecker
from repro.analysis import PageEvent as RefEvent
from repro.analysis import diff_fifo_occupancy as ref_diff_fifo
from repro.core import DMAEngine as RefDMA
from repro.core import PES as REF_PES
from repro.core import PULConfig as RefPULConfig
from repro.core import TIERS as REF_TIERS
from repro.serving import KVPagePool as RefPool
from repro.serving import PageConfig as RefPageConfig
from repro.serving import PagedEngineConfig as RefEngineConfig
from repro.serving import PagedServingEngine as RefEngine
from repro.serving import Request as RefRequest
from repro_torch.analysis import (
    EventKind,
    LifecycleChecker,
    LifecycleViolationError,
    TraceLog,
    check_page_trace,
    diff_fifo_occupancy,
    format_violations,
)
from repro_torch.configs import get_config
from repro_torch.core import PES, TIERS, DMAEngine, IssueStrategy, PULConfig
from repro_torch.serving import (
    KVPagePool,
    PackedKVLayout,
    PageConfig,
    PagedEngineConfig,
    PagedServingEngine,
    Request,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_serving as S  # noqa: E402  (bridged models, scripts)

FEATURES = 32


def _violations(events, final=False):
    """(rule, pid, seq) of each violation the port's checker and the
    reference's report on `events` (the port's PageEvents)."""
    ref_events = [RefEvent(**{**dataclasses.asdict(e),
                              "kind": RefKind(e.kind.value)}) for e in events]
    port, ref = LifecycleChecker(), RefChecker()
    port.feed(events)
    ref.feed(ref_events)
    if final:
        port.finalize()
        ref.finalize()
    return ([(v.rule, v.pid, v.seq) for v in port.violations],
            [(v.rule, v.pid, v.seq) for v in ref.violations])


def _events(log):
    return list(log.events)


# ------------------------------------------------------- synthetic traces
def _synthetic(*emits):
    def build():
        log = TraceLog()
        for clock, kind, fields in emits:
            log.emit(clock, EventKind(kind), **fields)
        return log
    return build


SYNTHETIC = {
    "refcount-underflow": (_synthetic(
        (0, "alloc", dict(pid=7, frame=2, refcount=1)),
        (1, "unref", dict(pid=7, refcount=0)),
        (1, "unref", dict(pid=7, refcount=-1))), ["refcount-underflow"]),
    "double-restore": (_synthetic(
        (0, "alloc", dict(pid=3, frame=2, refcount=1)),
        (1, "restore", dict(pid=3, frame=4))), ["double-restore"]),
    "double-evict": (_synthetic(
        (0, "alloc", dict(pid=3, frame=2, refcount=1)),
        (1, "evict", dict(pid=3, frame=2)),
        (2, "evict", dict(pid=3, frame=2))), ["double-evict"]),
    "deadline-order": (_synthetic(
        (0, "alloc", dict(pid=1, frame=2, refcount=1)),
        (0, "alloc", dict(pid=2, frame=3, refcount=1)),
        (0, "deadline", dict(pid=1, deadline=50.0)),
        (0, "deadline", dict(pid=2, deadline=10.0)),
        (1, "evict", dict(pid=2, frame=3, cause="steal"))), ["deadline-order"]),
    "deadline-order-pinned": (_synthetic(
        (0, "alloc", dict(pid=1, frame=2, refcount=1)),
        (0, "alloc", dict(pid=2, frame=3, refcount=1)),
        (0, "deadline", dict(pid=1, deadline=50.0)),
        (0, "deadline", dict(pid=2, deadline=10.0)),
        (1, "evict", dict(pid=2, frame=3, cause="steal", pinned=(1,)))), []),
    "frame-collision": (_synthetic(
        (0, "alloc", dict(pid=1, frame=2, refcount=1)),
        (0, "alloc", dict(pid=2, frame=2, refcount=1))), ["frame-collision"]),
    "restore-into-reserved": (_synthetic(
        (0, "alloc", dict(pid=1, frame=2, refcount=1)),
        (0, "evict", dict(pid=1, frame=2)),
        (1, "restore", dict(pid=1, frame=0))), ["frame-collision"]),
    "cross-layer-claims": (_synthetic(
        (0, "alloc", dict(pid=1, frame=2, refcount=1, layer=0)),
        (0, "alloc", dict(pid=2, frame=2, refcount=1, layer=1)),
        (1, "alloc", dict(pid=3, frame=2, refcount=1, layer=1))),
        ["frame-collision"]),
    "layer-claim-vs-whole-frame": (_synthetic(
        (0, "alloc", dict(pid=1, frame=2, refcount=1)),
        (0, "alloc", dict(pid=2, frame=2, refcount=1, layer=3))),
        ["frame-collision"]),
    "per-layer-writes-clean": (_synthetic(
        (0, "alloc", dict(pid=1, frame=2, refcount=1)),
        *[(1, "write_rows", dict(frames=(2,), layer=layer))
          for layer in range(3)]), []),
    "per-layer-write-foreign-layer": (_synthetic(
        (0, "alloc", dict(pid=1, frame=2, refcount=1, layer=0)),
        (1, "write_rows", dict(frames=(2,), layer=5))),
        ["write-to-non-hot-frame"]),
    "layer-scoped-release": (_synthetic(
        (0, "alloc", dict(pid=1, frame=2, refcount=1, layer=0)),
        (0, "alloc", dict(pid=2, frame=2, refcount=1, layer=1)),
        (1, "evict", dict(pid=1, frame=2)),
        (2, "write_rows", dict(frames=(2,), layer=1)),
        (3, "write_rows", dict(frames=(2,), layer=0))),
        ["write-to-non-hot-frame"]),
    "unref-unknown": (_synthetic(
        (0, "unref", dict(pid=9, refcount=-1))), ["refcount-underflow"]),
}


# ----------------------------------------- broken pool call sequences
def _port_pool(hot_frames=6):
    cfg = dataclasses.replace(get_config(S.ARCH).reduced(), paged_kv=True)
    layout = PackedKVLayout(cfg, 1, 16)
    pool = KVPagePool(PageConfig(page_tokens=8, hot_frames=hot_frames,
                                 trace=True), layout=layout, device="cpu")
    rows = lambda n: torch.ones((n, layout.features), dtype=torch.bfloat16)
    return pool, rows


def _ref_pool(hot_frames=6):
    pool = RefPool(RefPageConfig(page_tokens=8, hot_frames=hot_frames,
                                 trace=True), FEATURES)
    return pool, lambda n: jnp.ones((n, FEATURES), jnp.bfloat16)


def _clean(pool, rows):
    a = pool.alloc()
    b = pool.alloc(shared_key=("sys", 0))
    assert pool.lookup_shared(("sys", 0)) == b
    pool.note_deadline([a, b], 40.0)
    pool.evict(a)
    pool.ensure_hot([a, b])
    pool.write_page(a, rows(8), n_valid=8)
    pool.frames_of([a, b])
    pool.unref(a)
    pool.unref(b)
    pool.unref(b)


def _unref_after_free(pool, rows):
    pid = pool.alloc(shared_key=("p", 1))
    pool.unref(pid)
    pool.trace.emit(1, type(pool.trace.events[0].kind).UNREF, pid=pid,
                    refcount=-1)


def _leak(pool, rows):
    pool.alloc()
    freed = pool.alloc()
    pool.unref(freed)


def _use_after_evict(pool, rows):
    pid = pool.alloc()
    pool.evict(pid)
    with pytest.raises((AssertionError, RuntimeError), match="cold"):
        pool.frames_of([pid])          # the READ lands before the raise


def _write_zero_frame(pool, rows):
    pool.alloc()
    with pytest.raises((AssertionError, ValueError), match="zero frame"):
        pool.write_rows(np.array([0]), np.array([0]), rows(1))


def _write_unowned_frame(pool, rows):
    pool.alloc()
    pool.write_rows(np.array([pool.free_frames[0]]), np.array([0]), rows(1))


def _trash_writes(pool, rows):
    pid = pool.alloc()
    frame = int(pool.frames_of([pid])[0])
    pool.write_rows(np.array([1, frame]), np.array([0, 0]), rows(2))


def _churn(pool, rows):
    a = pool.alloc()
    b = pool.alloc(needed=[a])
    pool.note_deadline([a], 100.0)
    pool.note_deadline([b], 5.0)
    pool.evict(a)
    pool.ensure_hot([a, b])
    pool.alloc(needed=[b])              # steals a, restored this very step


def _pinned_alloc(pool, rows):
    a = pool.alloc()
    b = pool.alloc(needed=[a])
    pool.evict(a)
    pool.ensure_hot([a, b])
    with pytest.raises(RuntimeError, match="hot tier exhausted"):
        pool.alloc(needed=[a, b])


def _explicit_evict(pool, rows):
    a = pool.alloc()
    b = pool.alloc()
    pool.note_deadline([a], 99.0)
    pool.note_deadline([b], 1.0)
    pool.evict(b)


# name: (call sequence, hot frames, finalize, the rules the reference
# test expects)
SEQUENCES = {
    "clean-lifecycle": (_clean, 6, True, []),
    "unref-after-free": (_unref_after_free, 6, False, ["refcount-underflow"]),
    "refcount-leak": (_leak, 6, True, ["refcount-leak"]),
    "use-after-evict": (_use_after_evict, 6, False, ["use-after-evict"]),
    "write-zero-frame": (_write_zero_frame, 6, False,
                         ["write-to-non-hot-frame"]),
    "write-unowned-frame": (_write_unowned_frame, 6, False,
                            ["write-to-non-hot-frame"]),
    "trash-frame-writes": (_trash_writes, 6, False, []),
    "same-step-churn": (_churn, 4, False, ["evict-restore-churn"]),
    "pinned-alloc": (_pinned_alloc, 4, False, []),
    "explicit-evict": (_explicit_evict, 6, False, []),
}


def _as_dicts(events):
    return [{**dataclasses.asdict(e), "kind": e.kind.value} for e in events]


@pytest.mark.parametrize("case", sorted(SYNTHETIC) + sorted(SEQUENCES))
def test_checkers_agree_on_the_reference_cases(case):
    """Each case's events through both checkers: the same (rule, page,
    event) triples, carrying the rules the reference's test expects. A pool
    call sequence runs on both packages' pools and must give the same
    trace."""
    if case in SYNTHETIC:
        build, want = SYNTHETIC[case]
        events, final = _events(build()), False
    else:
        drive, hot, final, want = SEQUENCES[case]
        port, rows = _port_pool(hot)
        drive(port, rows)
        ref, ref_rows = _ref_pool(hot)
        drive(ref, ref_rows)
        assert _as_dicts(port.trace.events) == _as_dicts(ref.trace.events)
        events = _events(port.trace)
    got, ref_got = _violations(events, final=final)
    assert got == ref_got
    assert [rule for rule, _, _ in got] == want, format_violations(
        check_page_trace(events, final=final))


def test_feed_log_is_incremental_and_the_error_carries_provenance():
    pool, _ = _port_pool()
    checker = LifecycleChecker()
    a = pool.alloc()
    assert checker.feed_log(pool.trace) == []
    pool.evict(a)
    with pytest.raises(RuntimeError, match="cold"):
        pool.frames_of([a])
    fresh = checker.feed_log(pool.trace)
    assert [v.rule for v in fresh] == ["use-after-evict"]
    assert checker.feed_log(pool.trace) == [] and len(checker.violations) == 1
    err = LifecycleViolationError(fresh)
    assert err.violations == fresh and isinstance(err, AssertionError)
    assert "use-after-evict" in str(err) and f"page={a}" in str(err)


# ------------------------------------------------------ served traces
@pytest.fixture(scope="module")
def models():
    return S._models(S.ARCH)


PATHS = {"sweep": dict(use_paged_kernel=True, sweep_decode=True),
         "per-layer": dict(use_paged_kernel=True, sweep_decode=False),
         "assembly": dict(use_paged_kernel=False)}


@pytest.fixture(scope="module")
def served(models):
    """The fcfs script (prefix sharing, first-token replay, preempt/resume)
    through both engines with shadow_check on, per path: (reference engine,
    port engine)."""
    ref_cfg, ref_params, cfg, params = models
    out = {}
    for path, kw in PATHS.items():
        ref = RefEngine(ref_cfg, ref_params, RefEngineConfig(
            **{**S.BASE, **kw}, shadow_check=True))
        S._script_fcfs(ref, RefRequest)
        port = PagedServingEngine(cfg, params, PagedEngineConfig(
            **{**S.BASE, **kw}, shadow_check=True, device="cpu", **S.TIERS))
        S._script_fcfs(port, Request)
        out[path] = ref, port
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_served_trace_equals_the_reference_and_is_clean(served, path):
    ref, port = served[path]
    assert port.pool.metrics.page_faults >= 1
    assert port.pool.metrics.shared_hits >= 1
    assert _as_dicts(port.pool.trace.events) == _as_dicts(ref.pool.trace.events)
    assert port._shadow_checker.violations == []
    assert _violations(_events(port.pool.trace), final=True) == ([], [])


def _plant_unref(events):
    freed = next(e for e in reversed(events) if e.kind is EventKind.FREE)
    return events + [dataclasses.replace(freed, seq=len(events),
                                         kind=EventKind.UNREF, refcount=-1)]


def _plant_zero_write(events):
    return events + [dataclasses.replace(events[-1], seq=len(events),
                                         kind=EventKind.WRITE_ROWS, pid=None,
                                         frame=None, frames=(0,), layer=None)]


def _plant_read_after_evict(events):
    ev = next(e for e in events if e.kind is EventKind.EVICT)
    i = events.index(ev) + 1
    read = dataclasses.replace(ev, kind=EventKind.READ, cause=None)
    return [dataclasses.replace(e, seq=k) for k, e in
            enumerate(events[:i] + [read] + events[i:])]


def _drop_a_free(events):
    i = next(k for k, e in enumerate(events) if e.kind is EventKind.FREE)
    return [dataclasses.replace(e, seq=k) for k, e in
            enumerate(events[:i] + events[i + 1:])]


PLANTS = {"unref-after-free": (_plant_unref, "refcount-underflow"),
          "write-zero-frame": (_plant_zero_write, "write-to-non-hot-frame"),
          "read-after-evict": (_plant_read_after_evict, "use-after-evict"),
          "missing-free": (_drop_a_free, "refcount-leak")}


@pytest.mark.parametrize("plant", sorted(PLANTS))
@pytest.mark.parametrize("path", ["sweep", "assembly"])
def test_planted_corruptions_are_flagged_by_both(served, path, plant):
    corrupt, rule = PLANTS[plant]
    events = corrupt(_events(served[path][1].pool.trace))
    got, ref_got = _violations(events, final=True)
    assert got == ref_got
    assert rule in [r for r, _, _ in got]


# ---------------------------------------------------- engine shadow mode
@pytest.mark.parametrize("path", sorted(PATHS))
def test_engine_shadow_check_clean_under_preemption_pressure(models, path):
    """The reference's engine test (priority preemption, restores) on the
    port's engine: every tick checked, no violation."""
    _, _, cfg, params = models
    eng = PagedServingEngine(cfg, params, PagedEngineConfig(
        batch_slots=2, max_seq=64, page_tokens=8, prefill_buckets=(8, 16, 32),
        policy="priority", shadow_check=True, device="cpu", **PATHS[path]))
    assert eng.pool.trace is not None

    def prompt(seed, n):
        return np.random.default_rng(seed).integers(
            1, cfg.vocab_size, size=n).tolist()

    eng.submit(Request(rid=0, prompt=prompt(0, 9), max_new_tokens=12))
    eng.submit(Request(rid=1, prompt=prompt(1, 7), max_new_tokens=12))
    for _ in range(3):
        eng.step()
    eng.submit(Request(rid=2, prompt=prompt(2, 5), max_new_tokens=4,
                       priority=5))
    eng.run()
    assert eng.metrics.preemptions >= 1
    assert eng.pool.metrics.page_faults >= 1
    assert len(eng.pool.trace) > 0
    assert eng._shadow_checker.violations == []


def test_engine_shadow_check_raises_on_injected_corruption(models):
    _, _, cfg, params = models
    eng = PagedServingEngine(cfg, params, PagedEngineConfig(
        batch_slots=1, max_seq=64, page_tokens=8, prefill_buckets=(8, 16),
        shadow_check=True, device="cpu"))
    eng.submit(Request(rid=0, prompt=np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=6).tolist(), max_new_tokens=8))
    eng.step()
    eng.pool.trace.emit(0, EventKind.UNREF, pid=999, refcount=-1)
    with pytest.raises(LifecycleViolationError, match="refcount-underflow"):
        eng.step()


def test_shadow_check_off_records_no_trace(models):
    _, _, cfg, params = models
    eng = PagedServingEngine(cfg, params, PagedEngineConfig(
        batch_slots=1, max_seq=64, page_tokens=8, prefill_buckets=(8, 16),
        device="cpu"))
    assert eng.pool.trace is None and eng._shadow_checker is None


# ------------------------------------------------------- diff_fifo_occupancy
FIFO_CASES = {
    "d4-batch": dict(distance=4),
    "d8-sequential": dict(distance=8, strategy="SEQUENTIAL"),
    "d8-fifo8": dict(distance=8, fifo_depth=8),
    "d64-fifo64": dict(distance=64, fifo_depth=64),
}


def _fifo_run(DMA, Cfg, tier, pe, case, **cfg_kw):
    kw = dict(FIFO_CASES[case])
    fifo = kw.pop("fifo_depth", 64)
    kw.pop("strategy", None)
    eng = DMA(tier, pe, fifo_depth=fifo)
    cfg = Cfg(fifo_depth=fifo, **kw, **cfg_kw)
    eng.run_stream(cfg, n_blocks=96, block_bytes=4096,
                   compute_flops_per_block=4096.0)
    return cfg, eng.last_channels[0], fifo


@pytest.mark.parametrize("case", sorted(FIFO_CASES))
def test_diff_fifo_occupancy_matches_reference(case):
    """The same DMA-twin run on both packages (nvm tier, MicroBlaze PE):
    the executed occupancy logs are equal, and both diffs read the same
    divergences from them, also from a log planted one enqueue too deep
    and from a run held against a shallower distance than it ran."""
    strat = FIFO_CASES[case].get("strategy")
    port_kw = {"strategy": IssueStrategy[strat]} if strat else {}
    ref_kw = ({"strategy": type(RefPULConfig().strategy)[strat]}
              if strat else {})
    cfg, ch, fifo = _fifo_run(DMAEngine, PULConfig, TIERS["nvm"],
                              PES["microblaze"], case, **port_kw)
    rcfg, rch, _ = _fifo_run(RefDMA, RefPULConfig, REF_TIERS["nvm"],
                             REF_PES["microblaze"], case, **ref_kw)
    assert ch.occupancy_log == rch.occupancy_log
    assert ch.max_outstanding == rch.max_outstanding
    assert len(ch.stalls) == len(rch.stalls)
    n = 96
    assert diff_fifo_occupancy(cfg, n_blocks=n, channel=ch,
                               engine_fifo_depth=fifo) == \
        ref_diff_fifo(rcfg, n_blocks=n, channel=rch, engine_fifo_depth=fifo) \
        == []
    # a log one enqueue too deep, and a shallower plan than ran
    for c in (ch, rch):
        t, occ = c.occupancy_log[1]
        c.occupancy_log[1] = (t, occ + 5)
    shallow = dataclasses.replace(cfg, distance=1)
    rshallow = dataclasses.replace(rcfg, distance=1)
    got = diff_fifo_occupancy(cfg, n_blocks=n, channel=ch,
                              engine_fifo_depth=fifo)
    assert got and got == ref_diff_fifo(rcfg, n_blocks=n, channel=rch,
                                        engine_fifo_depth=fifo)
    assert diff_fifo_occupancy(shallow, n_blocks=n, channel=ch) == \
        ref_diff_fifo(rshallow, n_blocks=n, channel=rch)
