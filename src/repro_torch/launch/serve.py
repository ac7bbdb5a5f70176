"""Serving launcher of the port: paged, PUL-tiered continuous batching.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --reduced --requests 8 --max-new 12 --page-tokens 8 --slots 4

Runs on CUDA by default (the kernel-true decode through the port's Hopper
kernels); ``--device cpu`` runs the kernels' plain PyTorch versions.
``--no-sweep`` takes the per-layer kernel path instead of the fused sweep;
``--no-paged-kernel`` decodes by dense assembly from the pages; ``--dense``
serves with the dense reference engine (no pages; no --trace / --metrics).
Page-pool knobs: --page-tokens, --hot-pages (fast-tier frames; 0 = fit
everything), --distance (preload distance for page restores; 0 = planner
d*). Scheduling knobs: --policy (fcfs | priority | slo-edf; the latter two
preempt running requests, swapping their pages to the cold tier),
--prefill-chunk, --high-priority-every / --ttft-deadline. Weights are the
port's own random init from --seed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.obs import Tracer, validate_chrome_trace
from repro_torch.serving import (
    PagedServingEngine,
    Request,
    ServingConfig,
    ServingEngine,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dense", action="store_true",
                    help="use the dense-cache reference engine")
    ServingConfig.add_flags(ap)
    ap.add_argument("--high-priority-every", type=int, default=0,
                    help="mark every Nth request high-priority with a TTFT "
                         "deadline (0 = uniform workload)")
    ap.add_argument("--ttft-deadline", type=int, default=8,
                    help="TTFT deadline in ticks for high-priority requests")
    ap.add_argument("--log-every", type=int, default=8)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record a Chrome/Perfetto trace of the run to PATH")
    ap.add_argument("--metrics", metavar="PATH", default=None,
                    help="dump the final metrics registry to PATH — "
                         "Prometheus text for .prom, JSON otherwise")
    args = ap.parse_args(argv)
    if args.dense and (args.trace or args.metrics):
        ap.error("--trace/--metrics instrument the paged engine; "
                 "drop --dense")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    serving_cfg = ServingConfig.from_flags(args)
    params = init_params(cfg, seed=args.seed, device=serving_cfg.device)

    if args.dense:
        eng = ServingEngine(cfg, params, serving_cfg)
        print(f"[serve] {serving_cfg.device}: dense engine, prefill bucket "
              f"{serving_cfg.prefill_bucket}")
    else:
        hook = (lambda s: print(
            f"[serve] tick {s['tick']:4d}  {s['tokens_per_sec']:6.1f} tok/s"
            f"  live {s['live_slots']}  queued {s['queued']}"
            f"  faults {s['page_faults']}  shared {s['shared_page_hits']}"
            f"  hidden {s['modeled_restore_latency_hidden']:.0%}")
            if s["tick"] % args.log_every == 0 else None)
        tracer = Tracer() if args.trace else None
        eng = PagedServingEngine(cfg, params, serving_cfg, metrics_hook=hook,
                                 tracer=tracer)
        path = ("assembly" if not serving_cfg.use_paged_kernel
                else "fused sweep" if serving_cfg.sweep_decode
                else "per-layer")
        print(f"[serve] {serving_cfg.device}: paged KV {eng.layout.features} "
              f"packed features/token, {args.page_tokens} tokens/page, "
              f"planned d*={eng.pool.distance}, {path} decode")

    prompts = np.random.default_rng(args.seed).integers(
        1, cfg.vocab_size, size=(args.requests, 8)).tolist()
    t0 = time.time()
    for i, p in enumerate(prompts):
        hp = args.high_priority_every and (i % args.high_priority_every == 0)
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=args.max_new,
                           priority=1 if hp else 0,
                           ttft_deadline=args.ttft_deadline if hp else -1))
    out = eng.run()
    dt = time.time() - t0
    total = sum(len(v) for v in out.values())
    for rid, toks in sorted(out.items()):
        print(f"[serve] req {rid}: {toks}")
    print(f"[serve] {total} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s, {args.slots} slots)")
    if args.dense:
        return
    snap = eng.snapshot()
    print(f"[serve] pages allocated {snap['pages_allocated']}, faults "
          f"{snap['page_faults']}, evictions {snap['evictions']}, "
          f"shared hits {snap['shared_page_hits']}, mean queue wait "
          f"{snap['mean_queue_latency']:.1f} ticks")
    print(f"[serve] policy {snap['policy']}: preemptions "
          f"{snap['preemptions']}, readmissions {snap['readmissions']}, "
          f"chunk passes {snap['chunk_passes']}, SLO violations "
          f"{snap['slo_violations']}, rejected {snap['rejected']}")
    econ = eng.economics()
    for tier, t in econ["tiers"].items():
        print(f"[serve] {tier} tier: {t['bytes_moved']} bytes moved "
              f"({t['bytes_per_token']:.0f} B/token)")
    if args.trace:
        doc = eng.tracer.to_chrome(args.trace)
        errs = validate_chrome_trace(doc)
        if errs:
            raise RuntimeError("\n".join(errs))
        print(f"[serve] trace: {len(doc['traceEvents'])} events -> "
              f"{args.trace}")
    if args.metrics:
        reg = eng.metrics_registry()
        if args.metrics.endswith(".prom"):
            reg.dump_prometheus(args.metrics)
        else:
            reg.dump_json(args.metrics)
        print(f"[serve] metrics -> {args.metrics}")


if __name__ == "__main__":
    main()
