"""The port's serving benchmarks and serve example (repro_torch.benchmarks,
repro_torch.examples.serve_lm) vs the reference's scripts.

Reduced qwen3-1.7b, its weights bridged from the reference's init, runs
serving_slo's workload under each policy through the reference's
run_policy and the port's on the same decode path (the reference's engine
defaults to assembly, the port's to the kernel-true sweep, so both get the
path explicitly) with the reference's memory tiers patched into the port's
engine config: every tick-derived and counter-derived number is equal, and
the port's byte counters taken through serving_roofline with the
reference's roofline constants give the reference's fractions.
roofline.run_serving's bytes per token are equal on both tiers; the gate
rejects a value outside its band. kv_page_dma's sweep rows and printed
report equal the reference's at a tier and PE both packages have (nvm,
microblaze). flops' counts equal the reference's for every config the port
has, percentile equals the reference's. The scripts' entry points run on
the CPU with --device cpu --reduced and pass their gates against the port's
own reduced baselines, and raise without CUDA by default.
"""
import contextlib
import dataclasses
import functools
import io
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:            # the reference's benchmarks package
    sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from benchmarks import flops as ref_flops  # noqa: E402
from benchmarks import kv_page_dma as ref_dma  # noqa: E402
from benchmarks import roofline as ref_roofline  # noqa: E402
from benchmarks import serving_slo as ref_slo  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import DMAEngine as RefDMA  # noqa: E402
from repro.core import PES as REF_PES  # noqa: E402
from repro.core import TIERS as REF_TIERS  # noqa: E402
from repro.core import kv_page_latency_hidden as ref_hidden  # noqa: E402
from repro.core import plan_kv_page_stream as ref_plan  # noqa: E402
from repro.core import run_kv_page_workload as ref_run  # noqa: E402
from repro.serving import PagedEngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import percentile as ref_percentile  # noqa: E402
from repro_torch.benchmarks import (  # noqa: E402
    common,
    flops,
    kv_page_dma,
    paged_decode,
    roofline,
    serving_slo,
)
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core import PES, TIERS, plan_kv_page_stream  # noqa: E402
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.obs import serving_roofline  # noqa: E402
from repro_torch.serving import PagedEngineConfig, percentile  # noqa: E402

import test_torch_serving as S  # noqa: E402  (bridged models, tiers)

#: the reference's roofline constants, with which the port's byte counters
#: give the reference's fractions
REF_CONSTANTS = dict(peak_flops=ref_roofline.PEAK_BF16,
                     hot_bw=ref_roofline.HBM_BW, cold_bw=ref_roofline.LINK_BW)
#: the port's engine config with the reference's memory tiers
TIERED_CONFIG = functools.partial(PagedEngineConfig, **S.TIERS)
PATHS = {"sweep": dict(use_paged_kernel=True, sweep_decode=True),
         "assembly": dict(use_paged_kernel=False)}


@pytest.fixture(scope="module")
def models():
    ref_cfg, ref_params, cfg, params = S._models(S.ARCH)
    n = int(sum(x.size for x in jax.tree_util.tree_leaves(ref_params)))
    assert common.n_params_of(params) == n
    return ref_cfg, ref_params, cfg, params, n


# ------------------------------------------------------------ serving_slo
@pytest.fixture(scope="module")
def slo_runs(models):
    """{(path, policy): (reference row, port row)}."""
    ref_cfg, ref_params, cfg, params, n = models
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serving_slo, "PagedEngineConfig", TIERED_CONFIG)
        for path, kw in PATHS.items():
            # the reference's run_policy builds its engine config itself:
            # the path goes in through the class it calls
            mp.setattr(ref_slo, "PagedEngineConfig",
                       functools.partial(RefEngineConfig, **kw))
            for policy in ref_slo.POLICIES:
                ref = ref_slo.run_policy(ref_cfg, ref_params, policy, 64,
                                         n_params=n)
                port = serving_slo.run_policy(
                    cfg, params, policy, 64, path=path, device="cpu",
                    n_params=n)
                out[path, policy] = ref, port
    return out


EXACT = ("ticks", "tokens_emitted", "prefills", "preemptions",
         "readmissions", "slo_violations", "page_faults", "evictions",
         "mean_queue_latency_ticks", "ttft_p50_ticks", "ttft_p99_ticks",
         "high_priority", "cache_economics")


@pytest.mark.parametrize("policy", ["fcfs", "priority", "slo-edf"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_run_policy_matches_reference(slo_runs, path, policy):
    ref, port = slo_runs[path, policy]
    for key in EXACT:
        assert port[key] == ref[key], key
    assert serving_roofline(
        econ=port["cache_economics"], n_params=port["roofline"]["n_params"],
        tokens_emitted=port["tokens_emitted"], **REF_CONSTANTS) == \
        ref["roofline"]
    assert port["roofline"]["tiers"]["hot"]["peak_bw"] == roofline.HBM_BW
    assert port["path"] == path and port["device"] == "cpu"
    assert port["decode_ticks"] <= port["ticks"]


def test_contract_and_gate_hold_on_the_reduced_geometry(slo_runs):
    for path in PATHS:
        policies = {pol: slo_runs[path, pol][1] for pol in ref_slo.POLICIES}
        assert serving_slo.contract_failures(policies) == []
        gate = serving_slo.evaluate_gate(
            policies, common.default_baseline("serving", reduced=True))
        assert gate["pass"], gate
    # the contract reads what it says: a missed deadline breaks it
    broken = json.loads(json.dumps(policies))
    broken["slo-edf"]["high_priority"]["violations"] = 1
    broken["slo-edf"]["high_priority"]["ttft_p99_ticks"] = 99
    assert len(serving_slo.contract_failures(broken)) == 2


# --------------------------------------------------------------- roofline
@pytest.mark.parametrize("path", sorted(PATHS))
def test_run_serving_bytes_match_reference(models, path):
    ref_cfg, ref_params, cfg, params, _ = models
    with contextlib.redirect_stdout(io.StringIO()):
        ref = ref_roofline.run_serving(
            S.ARCH, use_kernel=PATHS[path]["use_paged_kernel"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(roofline, "PagedEngineConfig", TIERED_CONFIG)
        port = roofline.run_serving(cfg, params, path=path, device="cpu")
    for tier in ("hot", "cold"):
        for key in ("bytes_moved", "bytes_per_token"):
            assert port["tiers"][tier][key] == ref["tiers"][tier][key]
    # the byte counters through the reference's constants: its fractions
    again = serving_roofline(econ=port, n_params=port["n_params"],
                             tokens_emitted=port["tokens_emitted"],
                             **REF_CONSTANTS)
    assert again["modeled"] == ref["modeled"]
    for tier in ("hot", "cold"):
        assert again["tiers"][tier]["bw_fraction"] == \
            ref["tiers"][tier]["bw_fraction"]
    assert port["tokens_emitted"] == ref["tokens_emitted"] == 60


def test_serving_gate_rejects_values_outside_its_band(models):
    _, _, cfg, params, _ = models
    roof = roofline.run_serving(cfg, params, device="cpu")
    base = common.default_baseline("roofline_serving", reduced=True)
    assert roofline.evaluate_serving_gate(roof, base)["pass"]
    for scale in (1.3, 1 / 1.3):
        bad = json.loads(json.dumps(roof))
        bad["tiers"]["hot"]["bytes_per_token"] *= scale
        gate = roofline.evaluate_serving_gate(bad, base)
        assert not gate["pass"]
        assert [c["metric"] for c in gate["checks"] if not c["pass"]] == \
            ["hot_bytes_per_token"]


# ------------------------------------------------------------- kv_page_dma
def test_kv_page_dma_sweep_matches_reference():
    cfg = get_config(S.ARCH).reduced()
    from repro_torch.serving import PackedKVLayout
    F, gqa = PackedKVLayout(cfg, 1, 16).features, cfg.num_heads // cfg.num_kv_heads
    for P, feats in ((16, 128), (16, F), (8, 57344)):
        wl = kv_page_dma.workload(P, feats, gqa, steps=32)
        plan = plan_kv_page_stream(page_tokens=P, kv_features=feats,
                                   tier=TIERS["nvm"], pe=PES["microblaze"],
                                   gqa_group=gqa)
        rplan = ref_plan(page_tokens=P, kv_features=feats,
                         tier=REF_TIERS["nvm"], pe=REF_PES["microblaze"],
                         gqa_group=gqa)
        assert plan.cfg.distance == rplan.cfg.distance
        rows = kv_page_dma.sweep(TIERS["nvm"], PES["microblaze"], wl,
                                 plan.cfg.distance)
        tier, pe = REF_TIERS["nvm"], REF_PES["microblaze"]
        want = []
        for d, *_ in rows:
            stats = ref_run(RefDMA(tier, pe), wl, distance=d)
            want.append((d, stats.total_time, stats.io_throughput,
                         stats.pe_utilization,
                         ref_hidden(RefDMA(tier, pe), wl, distance=d)))
        assert rows == want
        diff, pre, _ = kv_page_dma.fifo_diff(
            TIERS["nvm"], PES["microblaze"], wl, plan.cfg.distance)
        assert diff == [] and len(pre.occupancy_log) == wl.n_pages


def test_kv_page_dma_report_matches_reference(tmp_path, monkeypatch):
    args = ["--tier", "nvm", "--pe", "microblaze", "--steps", "32",
            "--arch", S.ARCH, "--reduced"]
    trace = str(tmp_path / "trace.json")
    monkeypatch.setattr(sys, "argv", ["kv_page_dma", *args, "--trace", trace])
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        assert ref_dma.main() == 0
    port_out = io.StringIO()
    with contextlib.redirect_stdout(port_out):
        assert kv_page_dma.main([*args, "--trace", trace]) == 0
    assert port_out.getvalue() == ref_out.getvalue()
    assert "FIFO occupancy matches the symbolic schedule" in port_out.getvalue()


# ------------------------------------------------------------------ flops
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flops_match_reference(arch, reduced):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    if reduced:
        cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
    assert flops.active_params(cfg) == ref_flops.active_params(ref_cfg)
    assert flops.total_params(cfg) == ref_flops.total_params(ref_cfg)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(flops.cell_cost(cfg, shape)) == \
            dataclasses.asdict(ref_flops.cell_cost(ref_cfg, REF_SHAPES[name]))
        assert flops.collective_bytes(cfg, shape) == \
            ref_flops.collective_bytes(ref_cfg, REF_SHAPES[name])


# ------------------------------------------------------------- percentile
@pytest.mark.parametrize("xs", [[], [7], [3, 1, 4, 1, 5, 9, 2, 6],
                                np.linspace(-2.5, 11.0, 37).tolist()],
                         ids=["empty", "one", "ints", "floats"])
@pytest.mark.parametrize("q", [0, 50, 90, 99, 100])
def test_percentile_matches_reference(xs, q):
    got = percentile(xs, q)
    assert type(got) is float and got == ref_percentile(xs, q)


# ------------------------------------------------------- the entry points
def _quiet(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def test_scripts_run_on_cpu_and_pass_their_gates(tmp_path):
    out = str(tmp_path / "BENCH_serving.json")
    rc, text = _quiet(serving_slo.main, ["--device", "cpu", "--reduced",
                                         "--out", out])
    assert rc == 0 and "serving SLO contract + gate: PASS" in text
    rc, text = _quiet(roofline.main, ["--serving", "--reduced", "--device",
                                      "cpu", "--out", out])
    assert rc == 0 and "serving roofline gate: PASS" in text
    report = json.load(open(out))
    assert set(report) >= {"benchmark", "policies", "gate", "roofline",
                           "roofline_gate"}
    assert report["policies"]["slo-edf"]["path"] == "sweep"
    rc, text = _quiet(paged_decode.main, ["--device", "cpu", "--reduced"])
    assert rc == 0 and "4 of 4 requests identical" in text
    # without --serving, the dry-run table: it needs the dry-run's records
    # and exits 1 without any
    rc, text = _quiet(roofline.main, ["--dryrun-dir", str(tmp_path / "none"),
                                      "--csv", str(tmp_path / "r.csv")])
    assert rc == 1


def test_serve_lm_runs_on_cpu_and_finishes_every_request():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out, snap = serve_lm.main(["--device", "cpu", "--reduced"])
    assert sorted(out) == list(range(6))
    assert all(len(v) == 10 for v in out.values())
    assert snap["shared_page_hits"] >= 1 and snap["page_faults"] >= 1
    assert "60 tokens" in buf.getvalue()


@pytest.mark.parametrize("script", ["serving_slo", "paged_decode", "roofline",
                                    "serve_lm"])
def test_entry_points_default_to_cuda(script, monkeypatch):
    """Every entry point runs on the card unless asked for the CPU: without
    CUDA the default raises instead of falling back."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    main = {"serving_slo": serving_slo.main, "paged_decode": paged_decode.main,
            "roofline": functools.partial(roofline.main, ["--serving",
                                                          "--reduced"]),
            "serve_lm": serve_lm.main}[script]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--reduced"]) if script != "roofline" else main()
