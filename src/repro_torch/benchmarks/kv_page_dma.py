"""KV-page DMA benchmark of the port: the paged serving design on the DMA twin.

  PYTHONPATH=src python -m repro_torch.benchmarks.kv_page_dma \
      [--tier h100_pinned_host] [--pe h100_sm] [--page-tokens 16] \
      [--kv-features 128] [--gqa 4] [--arch qwen3-1.7b [--reduced]] \
      [--trace build/kv_page_dma_trace.json]

Port of the reference's ``benchmarks/kv_page_dma.py``. The defaults name
the port's own tier and PE: restores from pinned host memory across the
H100's host link (``core.pul.H100_PINNED_HOST``, where the port's cold tier
lives) into one H100 SM (``H100_SM``). ``--arch`` derives the page geometry
(packed KV features a token and the GQA group) from a served architecture
through the serving KV-store layout, the same ``PackedKVLayout`` the paged
engine serves with, instead of the raw --kv-features/--gqa numbers.

Verifies the planner's output statically, then sweeps the page-restore
preload distance on ``core.dma``'s KV-page workload and reports, per
distance: modeled restore throughput, PE utilization and the fraction of
page access latency hidden; the planner's d* row is marked. With
``--trace`` it re-runs the d* row on a traced ``DMAEngine``, writes a
Chrome/Perfetto trace and diffs the executed FIFO occupancy against the
plan verifier's symbolic schedule (``analysis.diff_fifo_occupancy``),
exiting 1 if they diverge. Pure host code: the twin models the copies, it
does not run them.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.plan_verifier import (
    diff_fifo_occupancy,
    verify_kv_page_plan,
)
from repro_torch.core import (
    DMAEngine,
    KVPageWorkload,
    PES,
    PULConfig,
    TIERS,
    kv_page_latency_hidden,
    plan_kv_page_stream,
    run_kv_page_workload,
)
from repro_torch.obs import Tracer, validate_chrome_trace


def workload(P, F, gqa, *, pages_per_step=4, steps=256) -> KVPageWorkload:
    """The decode stream of pages of P tokens x F bf16 features."""
    return KVPageWorkload(page_bytes=P * F * 2,
                          flops_per_page=4.0 * P * F * gqa,
                          pages_per_step=pages_per_step, steps=steps)


def sweep(tier, pe, wl, distance_star):
    """One row per distance in {1, 2, ..., 64, d*}: (d, modeled time s,
    restore throughput B/s, PE utilization, latency hidden)."""
    rows = []
    for d in sorted({1, 2, 4, 8, 16, 32, 64, distance_star}):
        stats = run_kv_page_workload(DMAEngine(tier, pe), wl, distance=d)
        hidden = kv_page_latency_hidden(DMAEngine(tier, pe), wl, distance=d)
        rows.append((d, stats.total_time, stats.io_throughput,
                     stats.pe_utilization, hidden))
    return rows


def fifo_diff(tier, pe, wl, distance, trace_path=None):
    """The d* row re-run on a traced engine: (divergences between the
    executed FIFO occupancy and the symbolic schedule, the preload
    channel, the trace document)."""
    tracer = Tracer()
    eng = DMAEngine(tier, pe, tracer=tracer)
    run_kv_page_workload(eng, wl, distance=distance)
    doc = tracer.to_chrome(trace_path)
    errs = validate_chrome_trace(doc)
    if errs:
        raise AssertionError("\n".join(errs))
    # the cfg run_kv_page_workload built for this run
    cfg = PULConfig(distance=min(distance, eng.fifo_depth),
                    fifo_depth=eng.fifo_depth, unload_distance=1)
    pre, _ = eng.last_channels
    diff = diff_fifo_occupancy(cfg, n_blocks=wl.n_pages, channel=pre,
                               engine_fifo_depth=eng.fifo_depth)
    return diff, pre, doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tier", default="h100_pinned_host", choices=sorted(TIERS))
    ap.add_argument("--pe", default="h100_sm", choices=sorted(PES))
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--kv-features", type=int, default=128)
    ap.add_argument("--gqa", type=int, default=4)
    ap.add_argument("--arch", default=None,
                    help="derive --kv-features/--gqa from a served arch's "
                         "KV-store layout (overrides both flags)")
    ap.add_argument("--reduced", action="store_true",
                    help="with --arch: use the reduced config")
    ap.add_argument("--pages-per-step", type=int, default=4)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="re-run the d* row traced, write the trace to PATH "
                         "and diff the executed FIFO occupancy against the "
                         "symbolic schedule (exit 1 if they diverge)")
    args = ap.parse_args(argv)

    tier, pe = TIERS[args.tier], PES[args.pe]
    P, F, gqa = args.page_tokens, args.kv_features, args.gqa
    if args.arch:
        from repro_torch.configs import get_config
        from repro_torch.serving import PackedKVLayout
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        layout = PackedKVLayout(cfg, 1, P)
        F = max(layout.features, 1)
        gqa = cfg.num_heads // max(cfg.num_kv_heads, 1)
        print(f"arch {args.arch}: layout v{layout.layout_version}, "
              f"{F} packed KV features/token, gqa group {gqa}")
    plan = plan_kv_page_stream(page_tokens=P, kv_features=F, tier=tier,
                               pe=pe, gqa_group=gqa)
    wl = workload(P, F, gqa, pages_per_step=args.pages_per_step,
                  steps=args.steps)
    # precondition: the planner's output must pass static verification
    # (coverage, issue ordering, FIFO discipline) before anything executes
    report = verify_kv_page_plan(plan, n_pages=wl.n_pages,
                                 page_bytes=wl.page_bytes)
    print(f"plan verified: d*={report.distance}, {report.n_blocks} pages, "
          f"peak in-flight window {report.max_in_flight}"
          + (f" ({len(report.warnings)} warning(s))" if report.warnings
             else ""))
    print(f"KV pages: {P} tok x {F} feat = {wl.page_bytes} B;"
          f" tier={tier.name} pe={pe.name} gqa={gqa}")
    print(f"planner: d*={plan.cfg.distance} ({plan.bound}-bound, predicted "
          f"{plan.predicted_utilization:.0%} PE utilization)\n")
    print(f"{'d':>4} {'time(us)':>10} {'GB/s':>8} {'PE util':>8} "
          f"{'latency hidden':>15}")
    for d, t, rate, util, hidden in sweep(tier, pe, wl, plan.cfg.distance):
        mark = "  <- d*" if d == plan.cfg.distance else ""
        print(f"{d:>4} {t * 1e6:>10.1f} {rate / 1e9:>8.2f} "
              f"{util:>7.0%} {hidden:>14.0%}{mark}")
    base = run_kv_page_workload(DMAEngine(tier, pe), wl,
                                distance=plan.cfg.distance, interleave=False)
    star = run_kv_page_workload(DMAEngine(tier, pe), wl,
                                distance=plan.cfg.distance)
    print(f"\ninterleaved vs phase-separated at d*: "
          f"{base.total_time / star.total_time:.2f}x")

    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        diff, pre, doc = fifo_diff(tier, pe, wl, plan.cfg.distance,
                                   trace_path=args.trace)
        print(f"\ntrace: {len(doc['traceEvents'])} events -> {args.trace}")
        if diff:
            print("FIFO occupancy diverges from the symbolic schedule:")
            for line in diff:
                print(f"  {line}")
            return 1
        print(f"FIFO occupancy matches the symbolic schedule "
              f"({len(pre.occupancy_log)} enqueues, high-water "
              f"{pre.max_outstanding} @ t={pre.high_water_time * 1e6:.1f}us)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
