"""Serving-policy SLO benchmark of the port: fcfs vs priority vs slo-edf.

  PYTHONPATH=src python -m repro_torch.benchmarks.serving_slo \
      [--arch qwen3-1.7b] [--reduced] [--device cuda] \
      [--path sweep|per-layer|assembly] [--steps 64] \
      [--out build/BENCH_serving.json] [--baseline PATH] [--trace-dir DIR]

Port of the reference's ``benchmarks/serving_slo.py``. Runs the SAME mixed
workload through the paged serving engine once per scheduling policy: two
long low-priority decoders grab both slots first, then three short
high-priority requests (tight TTFT deadline, in ticks) arrive behind them.
Under ``fcfs`` the shorts head-of-line-block until the longs drain, and
every deadline blows. ``priority`` preempts a long per short at once;
``slo-edf`` preempts only the requests whose deadline the lookahead says
cannot be met by waiting. Preempted requests swap out to the cold tier and
later resume mid-decode (their restores are the page-fault / eviction
counts below).

The decode path is named: ``--path sweep`` (default, the main path: the
kernel-true fused sweep K1, each step replayed from its captured CUDA
graph on the card), ``per-layer`` (K2) or ``assembly`` (dense decode over
pages gathered by K5). The reference's engine defaults to assembly; the
port's to the sweep, so the path is always passed explicitly.

Without ``--reduced`` the model is the config at full width with random
weights from seed 0. ``--device`` defaults to ``cuda`` and raises without
it; ``--device cpu`` runs the kernels' plain versions.

Writes the report (per-policy throughput, preemption counts, TTFT
percentiles in ticks, high-priority violation counts, the measured tick
medians, the gate) to ``--out`` and exits non-zero if the contract or the
gate fails.

Contract (hard-checked):
  * every policy finishes the full workload (identical token totals);
  * fcfs has >= 1 high-priority SLO violation, priority and slo-edf have 0;
  * slo-edf's high-priority TTFT p99 is STRICTLY better than fcfs's;
  * the baseline gate passes (throughput floor, TTFT-p99 ceiling), against
    the port's own baseline (``baselines/serving.json`` at full width,
    ``baselines/serving_reduced.json`` with ``--reduced``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np

from repro_torch.benchmarks.common import (
    DECODE_PATHS,
    default_baseline,
    load_model,
    timed_run,
)
from repro_torch.benchmarks.roofline import HBM_BW, LINK_BW, PEAK_BF16
from repro_torch.obs import Tracer, serving_roofline, validate_chrome_trace
from repro_torch.serving import (
    POLICIES,
    PagedEngineConfig,
    PagedServingEngine,
    Request,
    mean,
    percentile,
)

# small enough for the CPU tests, adversarial enough that fcfs provably
# blows every short request's deadline
WORKLOAD = dict(
    slots=2, max_seq=64, page_tokens=8, buckets=(8, 16, 32),
    long_requests=2, long_prompt=24, long_new=18,
    short_requests=3, short_prompt=6, short_new=4,
    ttft_deadline=6,
    warmup_ticks=2,        # longs decode this many ticks before shorts land
)


def _prompts(vocab):
    rng = np.random.default_rng(1234)
    longs = [rng.integers(1, vocab, size=WORKLOAD["long_prompt"]).tolist()
             for _ in range(WORKLOAD["long_requests"])]
    shorts = [rng.integers(1, vocab, size=WORKLOAD["short_prompt"]).tolist()
              for _ in range(WORKLOAD["short_requests"])]
    return longs, shorts


def engine_config(policy, *, path="sweep", device="cuda",
                  shadow_check=False) -> PagedEngineConfig:
    """The workload's engine config on decode path `path`."""
    w = WORKLOAD
    return PagedEngineConfig(
        batch_slots=w["slots"], max_seq=w["max_seq"],
        page_tokens=w["page_tokens"], prefill_buckets=w["buckets"],
        policy=policy, device=device, shadow_check=shadow_check,
        **DECODE_PATHS[path])


def run_policy(cfg, params, policy, steps, *, path="sweep", device="cuda",
               trace_path=None, n_params=0, shadow_check=False):
    """The workload under `policy`; returns its row of the report. Every
    tick is timed on the host (a decode tick ends in the logits' copy to
    the host, so it waits for the device); the tick medians beside the
    tick-derived numbers are over every tick, over the ticks that ran no
    prefill and over those that ran one."""
    w = WORKLOAD
    tracer = Tracer() if trace_path else None
    eng = PagedServingEngine(cfg, params, engine_config(
        policy, path=path, device=device, shadow_check=shadow_check),
        tracer=tracer)
    longs, shorts = _prompts(cfg.vocab_size)
    for i, p in enumerate(longs):
        eng.submit(Request(rid=i, prompt=list(p),
                           max_new_tokens=w["long_new"], priority=0))
    for _ in range(w["warmup_ticks"]):
        eng.step()
    hi_reqs = []
    for j, p in enumerate(shorts):
        r = Request(rid=100 + j, prompt=list(p),
                    max_new_tokens=w["short_new"], priority=1,
                    ttft_deadline=w["ttft_deadline"])
        hi_reqs.append(r)
        eng.submit(r)
    all_reqs = list(eng.requests.values())
    m, pm = eng.metrics, eng.pool.metrics
    ticks = timed_run(eng, steps)
    tick_ms = [s * 1e3 for s, _ in ticks]
    decode_ms = [s * 1e3 for s, prefill in ticks if not prefill]
    prefill_ms = [s * 1e3 for s, prefill in ticks if prefill]
    wall = sum(tick_ms) / 1e3

    ttfts = [r.ttft for r in all_reqs if r.ttft >= 0]
    hi_ttfts = [r.ttft for r in hi_reqs]
    if not all(t >= 0 for t in hi_ttfts):
        raise AssertionError(f"{policy}: a high-priority request never "
                             "emitted its first token")
    expected = (w["long_requests"] * w["long_new"]
                + w["short_requests"] * w["short_new"])
    if m.tokens_emitted != expected:
        raise AssertionError(f"{policy}: emitted {m.tokens_emitted}, "
                             f"expected {expected}")
    if trace_path:
        doc = tracer.to_chrome(trace_path)
        errs = validate_chrome_trace(doc)
        if errs:
            raise AssertionError(f"{policy} trace: " + "; ".join(errs))
        print(f"   trace: {len(doc['traceEvents'])} events -> {trace_path}")
    econ = eng.economics()
    return {
        "policy": policy,
        "path": path,
        "device": str(eng.device),
        "shadow_check": shadow_check,
        "wall_time_s": wall,
        "ticks": m.ticks,
        "tokens_emitted": m.tokens_emitted,
        "tokens_per_sec": m.tokens_emitted / wall if wall > 0 else 0.0,
        "tick_ms_median": statistics.median(tick_ms),
        "decode_tick_ms_median": statistics.median(decode_ms or [0.0]),
        "decode_ticks": len(decode_ms),
        "prefill_tick_ms_median": statistics.median(prefill_ms or [0.0]),
        "prefill_ticks": len(prefill_ms),
        "prefills": m.prefills,
        "decode_steps": m.decode_steps,
        "preemptions": m.preemptions,
        "readmissions": m.readmissions,
        "slo_violations": m.slo_violations,
        "page_faults": pm.page_faults,
        "evictions": pm.evictions,
        "mean_queue_latency_ticks": mean(eng.scheduler.queue_latencies()),
        "ttft_ticks": ttfts,
        "ttft_p50_ticks": percentile(ttfts, 50),
        "ttft_p99_ticks": percentile(ttfts, 99),
        "high_priority": {
            "ttft_ticks": hi_ttfts,
            "ttft_p50_ticks": percentile(hi_ttfts, 50),
            "ttft_p99_ticks": percentile(hi_ttfts, 99),
            "violations": sum(1 for t in hi_ttfts
                              if t > WORKLOAD["ttft_deadline"]),
        },
        "cache_economics": econ,
        # achieved-vs-peak bandwidth per KV tier over this policy's run,
        # counter-derived and deterministic (roofline --serving gates the
        # same accounting)
        "roofline": serving_roofline(
            econ=econ, n_params=n_params, tokens_emitted=m.tokens_emitted,
            peak_flops=PEAK_BF16, hot_bw=HBM_BW, cold_bw=LINK_BW),
    }


def contract_failures(policies):
    """The contract's broken clauses (an empty list: it holds)."""
    failures = []
    if policies["fcfs"]["high_priority"]["violations"] < 1:
        failures.append("fcfs shows no SLO violations: the workload is not "
                        "adversarial enough to distinguish policies")
    for pol in ("priority", "slo-edf"):
        if policies[pol]["high_priority"]["violations"] != 0:
            failures.append(f"{pol} missed a high-priority deadline")
    p99_fcfs = policies["fcfs"]["high_priority"]["ttft_p99_ticks"]
    p99_edf = policies["slo-edf"]["high_priority"]["ttft_p99_ticks"]
    if not p99_edf < p99_fcfs:
        failures.append(f"slo-edf hp TTFT p99 ({p99_edf}) not strictly "
                        f"better than fcfs ({p99_fcfs})")
    return failures


def evaluate_gate(policies, baseline_path):
    """Gate the slo-edf run against checked-in floors/ceilings.

    tokens_per_sec passes when measured >= baseline / threshold (a
    threshold-x slack throughput floor: wall clock); TTFT p99 passes when
    measured <= baseline * threshold (a latency ceiling; tick-derived, so
    deterministic)."""
    with open(baseline_path) as f:
        base = json.load(f)
    edf = policies["slo-edf"]
    checks = []
    spec = base["tokens_per_sec"]
    checks.append({
        "metric": "tokens_per_sec",
        "measured": edf["tokens_per_sec"],
        "baseline": spec["baseline"],
        "threshold": spec["threshold"],
        "pass": edf["tokens_per_sec"] >= spec["baseline"] / spec["threshold"],
    })
    spec = base["high_priority_ttft_p99_ticks"]
    measured = edf["high_priority"]["ttft_p99_ticks"]
    checks.append({
        "metric": "high_priority_ttft_p99_ticks",
        "measured": measured,
        "baseline": spec["baseline"],
        "threshold": spec["threshold"],
        "pass": measured <= spec["baseline"] * spec["threshold"],
    })
    return {
        "baseline": baseline_path,
        "checks": checks,
        "pass": all(c["pass"] for c in checks),
    }


def policy_line(p) -> str:
    """One policy's summary line."""
    hot = p["cache_economics"]["tiers"]["hot"]
    return (f"ticks={p['ticks']} tok/s={p['tokens_per_sec']:.2f} "
            f"tick_ms_median={p['tick_ms_median']:.3f} "
            f"decode_tick_ms_median={p['decode_tick_ms_median']:.3f} "
            f"prefill_tick_ms_median={p['prefill_tick_ms_median']:.3f} "
            f"ttft_p50={p['ttft_p50_ticks']} ttft_p99={p['ttft_p99_ticks']} "
            f"preempt={p['preemptions']} "
            f"hp_ttft={p['high_priority']['ttft_ticks']} "
            f"hp_violations={p['high_priority']['violations']} "
            f"hot_B/tok={hot['bytes_per_token']:.0f} "
            f"hot_bw={p['roofline']['tiers']['hot']['bw_fraction']:.4%}")


def run_all(cfg, params, steps=64, *, trace_dir=None, **kw):
    """Every policy in turn, printing its line (and, with `trace_dir`,
    writing its trace there); returns {policy: row}."""
    policies = {}
    for policy in POLICIES:
        trace = (os.path.join(trace_dir, f"trace_{policy}.json")
                 if trace_dir else None)
        policies[policy] = run_policy(cfg, params, policy, steps,
                                      trace_path=trace, **kw)
        print(f"== {policy} == " + policy_line(policies[policy]))
    return policies


def report(arch, steps, policies, gate):
    """The BENCH JSON report of one run of the three policies."""
    p99_fcfs = policies["fcfs"]["high_priority"]["ttft_p99_ticks"]
    p99_edf = policies["slo-edf"]["high_priority"]["ttft_p99_ticks"]
    return {
        "benchmark": "serving_slo",
        "arch": arch,
        "config": {"steps": steps, **{k: v for k, v in WORKLOAD.items()
                                      if k not in ("buckets",
                                                   "warmup_ticks")}},
        "policies": policies,
        "comparison": {
            "high_priority_ttft_p99_fcfs": p99_fcfs,
            "high_priority_ttft_p99_slo_edf": p99_edf,
            "slo_edf_strictly_better": p99_edf < p99_fcfs,
        },
        "gate": gate,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (the CPU tests' geometry)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without it) or cpu")
    ap.add_argument("--path", default="sweep", choices=sorted(DECODE_PATHS),
                    help="decode path (sweep: the kernel-true fused sweep)")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--out", default="build/BENCH_serving.json")
    ap.add_argument("--baseline", default=None,
                    help="gate baseline (default: the port's own, for the "
                         "full-width or --reduced geometry)")
    ap.add_argument("--trace-dir", metavar="DIR", default=None,
                    help="also write a Chrome/Perfetto trace per policy to "
                         "DIR/trace_<policy>.json")
    args = ap.parse_args(argv)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)

    cfg, params, n_params = load_model(args.arch, reduced=args.reduced,
                                       device=args.device)
    policies = run_all(cfg, params, args.steps, trace_dir=args.trace_dir,
                       path=args.path, device=args.device, n_params=n_params)

    failures = contract_failures(policies)
    gate = evaluate_gate(policies, args.baseline
                         or default_baseline("serving", args.reduced))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report(args.arch, args.steps, policies, gate), f, indent=2)
    print(f"wrote {args.out}")

    for c in gate["checks"]:
        status = "PASS" if c["pass"] else "FAIL"
        print(f"   gate {c['metric']}: {c['measured']:.6g} vs baseline "
              f"{c['baseline']} (threshold {c['threshold']}x) [{status}]")
    for msg in failures:
        print(f"CONTRACT FAIL: {msg}")
    if failures or not gate["pass"]:
        return 1
    print("serving SLO contract + gate: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
