"""The port's assembly decode path and dense ServingEngine vs the reference,
reduced qwen3 and reduced deepseek-v2 (MLA + MoE).

Assembly: the port's PagedServingEngine(use_paged_kernel=False) runs the
request scripts of test_torch_serving against the reference's engine on its
own assembly path. Counters and PoolMetrics must be equal; greedy tokens
agree up to the reference's first near-tie (the near-tie rule of
test_torch_serving). Inside the port the two gather routes (the PUL gather
K5, here its plain version, and plain indexing) agree bitwise, and assembly
agrees with the kernel-true sweep under the near-tie rule: its dense
attention sums in another order than K1/K3.

Dense engine: the port's ServingEngine against the reference's on the same
requests (both see the same batch composition, so MoE is comparable), and
greedy=False sampling across the port's dense and paged engines.
"""
import io
import contextlib

import numpy as np
import pytest

from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import PagedEngineConfig as RefPagedConfig
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefServingEngine
from repro_torch.launch import serve
from repro_torch.serving import (
    EngineConfig,
    PagedEngineConfig,
    PagedServingEngine,
    Request,
    ServingConfig,
    ServingEngine,
)
from test_torch_serving import (
    ARCH,
    BASE,
    DEEPSEEK,
    REL,
    SCRIPTS,
    TIERS,
    _counters,
    _models,
    _RefRecorder,
)


@pytest.fixture(scope="module")
def all_models():
    return {ARCH: _models(ARCH), DEEPSEEK: _models(DEEPSEEK)}


def _near_tie(logits) -> bool:
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return top[1] - top[0] < REL * np.abs(logits).max()


class _Recorder(PagedServingEngine):
    """Port engine that records, per request, whether each emitted token
    came from a near-tie of its logits."""

    def _emit_token(self, slot, logits):
        self.gaps.setdefault(self.slot_req[slot].rid, []).append(
            _near_tie(logits))
        super()._emit_token(slot, logits)


def _paged(cfg, params, kw, **path):
    eng = _Recorder(cfg, params, PagedEngineConfig(
        **{**BASE, **kw, **path}, device="cpu", **TIERS))
    eng.gaps = {}
    return eng


def _agree_up_to_ties(got, want, ties):
    """Tokens equal up to each request's first near-tie; returns how many
    were compared."""
    compared = 0
    for rid, toks in want.items():
        t = ties[rid]
        upto = t.index(True) if True in t else len(toks)
        assert got[rid][:upto] == toks[:upto], f"request {rid}"
        compared += upto
    return compared


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("arch", [ARCH, DEEPSEEK])
def test_assembly_engine_matches_reference_engine(all_models, arch, script):
    ref_cfg, ref_params, cfg, params = all_models[arch]
    drive, kw = SCRIPTS[script]
    ref = _RefRecorder(ref_cfg, ref_params, RefPagedConfig(
        **{**BASE, **kw, "use_paged_kernel": False}))
    ref.gaps = {}
    want = drive(ref, RefRequest)

    gather = _paged(cfg, params, kw, use_paged_kernel=False,
                    use_pallas_gather=True)
    got = drive(gather, Request)
    assert _counters(gather) == _counters(ref)
    assert gather.pool.metrics.page_faults >= 1
    gather.pool.metrics.validate()
    total = sum(len(t) for t in want.values())
    assert _agree_up_to_ties(got, want, ref.gaps) >= total // 2

    # in-port contract: the two gather routes give the same tokens bitwise
    plain = _paged(cfg, params, kw, use_paged_kernel=False,
                   use_pallas_gather=False)
    assert drive(plain, Request) == got
    assert _counters(plain) == _counters(gather)

    # assembly vs the kernel-true sweep: the near-tie rule
    sweep = _paged(cfg, params, kw, sweep_decode=True)
    assert _agree_up_to_ties(drive(sweep, Request), got,
                             gather.gaps) >= total // 2
    assert _counters(sweep) == _counters(gather)


# ---------------------------------------------------------------- dense
def _dense_script(eng, Req, vocab):
    """More requests than slots (mid-stream re-prefills), mixed lengths."""
    rng = np.random.default_rng(42)
    for i, n in enumerate((3, 17, 8, 29, 11)):
        eng.submit(Req(rid=i, prompt=rng.integers(1, vocab, size=n).tolist(),
                       max_new_tokens=6))
    return eng.run()


class _RefDense(RefServingEngine):
    """Reference dense engine recording near-ties per request."""

    def _emit(self, logits):
        for i, r in enumerate(self.slot_req):
            if r is not None:
                self.gaps.setdefault(r.rid, []).append(_near_tie(logits[i]))
        super()._emit(logits)


@pytest.mark.parametrize("arch", [ARCH, DEEPSEEK])
def test_dense_engine_matches_reference_engine(all_models, arch):
    ref_cfg, ref_params, cfg, params = all_models[arch]
    dense = dict(batch_slots=2, max_seq=64, prefill_bucket=32)
    ref = _RefDense(ref_cfg, ref_params, RefEngineConfig(**dense))
    ref.gaps = {}
    want = _dense_script(ref, RefRequest, cfg.vocab_size)
    eng = ServingEngine(cfg, params, EngineConfig(**dense, device="cpu"))
    got = _dense_script(eng, Request, cfg.vocab_size)
    assert sorted(got) == sorted(want) == list(range(5))
    assert all(len(t) == 6 for t in got.values())
    total = sum(len(t) for t in want.values())
    assert _agree_up_to_ties(got, want, ref.gaps) >= total // 2


def test_sampling_differential_across_engines(all_models):
    """greedy=False with one shared sample_seed: the port's dense engine and
    paged engine (assembly path, the same dense attention) draw identical
    streams when the prompt length equals the bucket (left and right
    padding then coincide), and the seed matters."""
    _, _, cfg, params = all_models[ARCH]
    prompt = list(range(3, 19))                    # 16 tokens == the bucket
    outs = []
    for seed in (0, 7):
        dense = ServingEngine(cfg, params, EngineConfig(
            batch_slots=2, max_seq=64, prefill_bucket=16, greedy=False,
            sample_seed=seed, device="cpu"))
        paged = PagedServingEngine(cfg, params, PagedEngineConfig(
            batch_slots=2, max_seq=64, page_tokens=8, prefill_buckets=(16,),
            use_paged_kernel=False, greedy=False, sample_seed=seed,
            device="cpu"))
        for eng in (dense, paged):
            eng.submit(Request(rid=0, prompt=list(prompt), max_new_tokens=8))
        a, b = dense.run()[0], paged.run()[0]
        assert a == b, f"seed {seed}: {a} != {b}"
        outs.append(a)
    assert outs[0] != outs[1]                      # seed actually matters


# ---------------------------------------------------------------- surface
def test_serving_config_projects_device_onto_the_dense_engine():
    assert ServingConfig(device="cpu").dense().device == "cpu"
    assert ServingConfig().dense() == EngineConfig(prefill_bucket=64)


@pytest.mark.parametrize("flags,want", [
    (["--dense"], "dense engine"),
    (["--no-paged-kernel"], "assembly decode"),
], ids=["dense", "assembly"])
def test_serve_cli_runs_new_paths_on_cpu(flags, want):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", ARCH, "--reduced", "--requests", "3",
                    "--max-new", "4", "--slots", "2", "--max-seq", "32",
                    "--page-tokens", "8", "--device", "cpu", *flags])
    out = buf.getvalue()
    assert want in out and "12 tokens" in out


def test_serve_cli_refuses_trace_with_dense(tmp_path):
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--reduced", "--dense", "--device", "cpu",
                    "--trace", str(tmp_path / "t.json")])
