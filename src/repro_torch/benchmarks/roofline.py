"""Roofline of the port: the dry-run table, and the serving roofline
(achieved-vs-peak bandwidth per KV tier).

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline \
      [--dryrun-dir results/dryrun] [--csv results/roofline.csv]

The default mode reads the dry-run's records (``repro_torch.launch.dryrun``,
one JSON per (arch x shape x mesh) cell) and prints three terms per cell,
in seconds, on the card's peaks (port of the reference's ``analyze`` and
``to_markdown``):
  compute    = EXEC_FLOPS / (chips * PEAK_BF16)
  memory     = EXEC_BYTES / (chips * HBM_BW)
  collective = per-device collective wire bytes / NVLINK_BW
EXEC_FLOPS and EXEC_BYTES are the analytic model's (``benchmarks.flops``,
global); the FLOPs the dry-run counted on a device's local shards are
printed beside as a cross-check. The dry-run counts collectives as they
execute, so its bytes already hold every loop trip (the reference scales
its compiled program's static bytes by scan trip counts).

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline --serving \
      [--serving-arch qwen3-1.7b] [--reduced] [--device cuda] \
      [--path sweep|per-layer|assembly] [--out build/BENCH_serving.json]

Port of the reference's ``benchmarks/roofline.py --serving``. It runs a
small deterministic workload (6 requests over 3 slots with a shared-prefix
pair and one preempt/resume, so the cold tier moves bytes) through the
paged engine on ``--path`` (default ``sweep``, the kernel-true fused sweep
K1), computes each KV tier's achieved-vs-peak bandwidth fraction from the
pool's tick-exact byte counters (``repro_torch.obs.serving_roofline``:
modeled, not wall time), merges the report into ``--out`` and gates the
fractions against the port's own baseline
(``baselines/roofline_serving.json`` at full width,
``baselines/roofline_serving_reduced.json`` with ``--reduced``). Exits
non-zero on a gate failure.

Without ``--reduced`` the model is the config at full width with random
weights from seed 0; ``--device`` defaults to ``cuda`` and raises without
it (``--device cpu`` runs the kernels' plain versions).

Hardware constants, one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the 700 W power limit):
  peak bf16   989 TFLOP/s
  HBM bw      3.35 TB/s   (the hot tier: device memory)
  host link   64 GB/s     (the cold tier: pinned host memory across PCIe
                           Gen5 x16, one direction; the port's copies
                           measured 52.06 GB/s, ``core.pul.H100_PINNED_HOST``)
  NVLink      450 GB/s    (card to card: NVLink 4, 18 links, 900 GB/s both
                           directions together, so 450 GB/s each way)
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import glob
import json
import os
import sys
from pathlib import Path

import numpy as np

from repro_torch.benchmarks.flops import cell_cost
from repro_torch.benchmarks.common import (
    DECODE_PATHS,
    default_baseline,
    load_model,
    n_params_of,
)
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.pul import H100_PINNED_HOST
from repro_torch.obs import serving_roofline
from repro_torch.serving import PagedEngineConfig, PagedServingEngine, Request

PEAK_BF16 = 989e12
HBM_BW = 3.35e12
LINK_BW = 64e9
#: card-to-card rate of the dry-run's collective term: NVLink 4 on the H100
#: SXM, 900 GB/s both directions together, 450 GB/s each way (NVIDIA's data
#: sheet); LINK_BW is the host link, not this
NVLINK_BW = 450e9
#: the cold tier's rate as the port's copies measured it (pinned host to
#: device, ``core.pul.H100_PINNED_HOST``), printed beside LINK_BW
MEASURED_LINK_BW = H100_PINNED_HOST.bandwidth

# metrics a roofline_serving baseline entry may gate, by key
_SERVING_METRICS = {
    "hot_bw_fraction": lambda r: r["tiers"]["hot"]["bw_fraction"],
    "cold_bw_fraction": lambda r: r["tiers"]["cold"]["bw_fraction"],
    "hot_bytes_per_token": lambda r: r["tiers"]["hot"]["bytes_per_token"],
    "cold_bytes_per_token": lambda r: r["tiers"]["cold"]["bytes_per_token"],
}


def run_serving(cfg, params, *, steps: int = 160, path: str = "sweep",
                device: str = "cuda"):
    """Run the deterministic serving workload; return the roofline report.

    Mirrors ``repro_torch.examples.serve_lm``'s shape: 6 requests over 3
    slots with a shared-prefix pair, warm-up decode, then one
    preempt/resume so evictions and restores (the cold tier's traffic)
    appear in the counters."""
    engine_cfg = PagedEngineConfig(
        batch_slots=3, max_seq=96, page_tokens=8,
        prefill_buckets=(8, 16, 32), device=device, **DECODE_PATHS[path])
    eng = PagedServingEngine(cfg, params, engine_cfg)

    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, size=8).tolist()
    for i in range(6):
        if i < 2:
            prompt = shared + rng.integers(
                1, cfg.vocab_size, size=rng.integers(1, 6)).tolist()
        else:
            prompt = rng.integers(1, cfg.vocab_size,
                                  size=rng.integers(3, 12)).tolist()
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=10))
    for _ in range(4):
        eng.step()
    victim = next((i for i, r in enumerate(eng.slot_req) if r is not None),
                  None)
    if victim is not None:
        eng.preempt(victim)
        eng.step()
        eng.resume(victim)
    out = eng.run(max_ticks=steps)
    if not all(len(v) == 10 for v in out.values()):
        raise AssertionError("serving workload did not finish every request")
    if eng.pool.metrics.evictions < 1 or eng.pool.metrics.page_faults < 1:
        raise AssertionError("preempt/resume moved no bytes through the "
                             "cold tier")

    roof = serving_roofline(econ=eng.economics(),
                            n_params=n_params_of(params),
                            tokens_emitted=eng.metrics.tokens_emitted,
                            peak_flops=PEAK_BF16, hot_bw=HBM_BW,
                            cold_bw=LINK_BW)
    roof["arch"] = cfg.name
    roof["steps"] = steps
    roof["decode_steps"] = eng.metrics.decode_steps
    roof["path"] = path
    roof["paged_kernel"] = engine_cfg.use_paged_kernel
    roof["sweep_decode"] = bool(engine_cfg.use_paged_kernel
                                and engine_cfg.sweep_decode)
    roof["device"] = str(eng.device)
    roof["tiers"]["cold"]["measured_link_bw"] = MEASURED_LINK_BW
    return roof


def evaluate_serving_gate(roof, baseline_path):
    """Gate serving roofline metrics against a checked-in baseline.

    Every metric here is counter-derived and deterministic, so the gate is
    a two-sided band: measured must sit within [baseline / threshold,
    baseline * threshold]. Above-band = traffic regression (a copy crept
    back into the zero-copy path, or the fused commit double-writes);
    below-band = the byte accounting itself broke.
    """
    with open(baseline_path) as f:
        base = json.load(f)
    checks = []
    for metric, spec in sorted(base.items()):
        if metric.startswith("_"):      # _comment etc.
            continue
        measured = _SERVING_METRICS[metric](roof)
        lo = spec["baseline"] / spec["threshold"]
        hi = spec["baseline"] * spec["threshold"]
        checks.append({
            "metric": metric,
            "measured": measured,
            "baseline": spec["baseline"],
            "threshold": spec["threshold"],
            "pass": lo <= measured <= hi,
        })
    return {
        "baseline": baseline_path,
        "checks": checks,
        "pass": all(c["pass"] for c in checks),
    }


def merge_report(out_path, key, value):
    """Merge `value` under `key` into the JSON report at `out_path`,
    keeping whatever another script already wrote there."""
    report = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            report = json.load(f)
    report[key] = value
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)


def print_serving(roof, gate) -> None:
    """The report's lines: each tier's bytes and fraction, and the gate."""
    m = roof["modeled"]
    print(f"serving roofline [{roof['arch']}, {roof['path']} on "
          f"{roof['device']}]: {roof['tokens_emitted']} tokens, critical "
          f"path {m['critical_path_s'] * 1e6:.3f}us ({m['dominant']}-bound)")
    for tier, t in roof["tiers"].items():
        extra = ""
        if tier == "cold":
            extra = (f" (the port's copies measured "
                     f"{t['measured_link_bw'] / 1e9:.2f} GB/s)")
        print(f"  {tier:>4}: {t['bytes_moved']:>11} B moved "
              f"({t['bytes_per_token']:.1f} B/tok), achieved "
              f"{t['achieved_bw'] / 1e9:.2f} GB/s of "
              f"{t['peak_bw'] / 1e9:.0f} GB/s peak "
              f"= {t['bw_fraction']:.4%}{extra}")
    for c in gate["checks"]:
        status = "PASS" if c["pass"] else "FAIL"
        print(f"   gate {c['metric']}: {c['measured']:.6g} vs baseline "
              f"{c['baseline']:.6g} (band {c['threshold']}x) [{status}]")


def serving_main(args) -> int:
    cfg, params, _ = load_model(args.serving_arch, reduced=args.reduced,
                                device=args.device)
    roof = run_serving(cfg, params, steps=args.serving_steps, path=args.path,
                       device=args.device)
    gate = evaluate_serving_gate(
        roof, args.serving_baseline
        or default_baseline("roofline_serving", args.reduced))
    merge_report(args.out, "roofline", roof)
    merge_report(args.out, "roofline_gate", gate)
    print_serving(roof, gate)
    print(f"wrote {args.out}")
    if not gate["pass"]:
        print("serving roofline gate: FAIL")
        return 1
    print("serving roofline gate: PASS")
    return 0


# --------------------------------------------------------------------------
# the dry-run table
# --------------------------------------------------------------------------
def analyze(dryrun_dir: str):
    """One row per dry-run record: the three terms of an ok cell, the
    reason of a skipped one, the exception of an error cell."""
    rows = []
    for f in sorted(glob.glob(f"{dryrun_dir}/*.json")):
        with open(f) as fh:
            r = json.load(fh)
        if r["status"] != "ok":
            rows.append({"arch": r["arch"], "shape": r["shape"],
                         "mesh": r["mesh"], "status": r["status"],
                         "note": r.get("reason") or r.get("error", "")})
            continue
        # the record's depth: a cell may have been run cut to fewer layers
        cfg = dataclasses.replace(get_config(r["arch"]),
                                  num_layers=r["num_layers"])
        shape = SHAPES[r["shape"]]
        chips = r["chips"]
        cost = cell_cost(cfg, shape, accum=r.get("accum") or 0)
        t_compute = cost.exec_flops / (chips * PEAK_BF16)
        t_memory = cost.exec_bytes / (chips * HBM_BW)
        t_coll = r["collective_bytes_per_dev"] / NVLINK_BW
        terms = {"compute": t_compute, "memory": t_memory,
                 "collective": t_coll}
        dominant = max(terms, key=terms.get)
        step_time = max(terms.values())
        # roofline fraction: MFU-style for train/prefill (useful compute vs
        # bottleneck), MBU-style for decode (achieved bandwidth vs HBM peak)
        t_useful = cost.model_flops / (chips * PEAK_BF16)
        if shape.kind == "decode":
            frac = t_memory / step_time if step_time > 0 else 0.0
        else:
            frac = t_useful / step_time if step_time > 0 else 0.0
        peak = r.get("peak_bytes_per_dev")
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "status": "ok", "chips": chips, "num_layers": r["num_layers"],
            "t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant,
            "roofline_frac": frac,
            "model_flops": cost.model_flops, "exec_flops": cost.exec_flops,
            "useful_ratio": cost.model_flops / cost.exec_flops,
            "exec_bytes": cost.exec_bytes,
            "counted_flops_per_dev": r["flops_per_dev"],
            "counted_over_exec": r["flops_per_dev"]
            / (cost.exec_flops / chips),
            "peak_gib_per_dev": None if peak is None else peak / 2**30,
            "accum": r.get("accum"),
        })
    return rows


def to_markdown(rows) -> str:
    out = ["| arch | shape | mesh | layers | compute s | memory s | "
           "collective s | dominant | MODEL/EXEC | counted/EXEC | "
           "roofline frac | peak GiB/dev |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — "
                       f"| — | — | {r['status']} | — | — | — | — |")
            continue
        peak = ("—" if r["peak_gib_per_dev"] is None
                else f"{r['peak_gib_per_dev']:.2f}")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['num_layers']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['counted_over_exec']:.3f} "
            f"| {r['roofline_frac']:.2%} | {peak} |")
    return "\n".join(out)


def dryrun_main(args) -> int:
    rows = analyze(args.dryrun_dir)
    if not rows:
        print(f"roofline: no dry-run records under {args.dryrun_dir}; run "
              "python -m repro_torch.launch.dryrun --all first",
              file=sys.stderr)
        return 1
    ok = [r for r in rows if r["status"] == "ok"]
    if ok:
        Path(args.csv).parent.mkdir(parents=True, exist_ok=True)
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(ok[0].keys()))
            w.writeheader()
            for r in ok:
                w.writerow(r)
    print(to_markdown(rows))
    if ok:
        worst_frac = min(ok, key=lambda r: r["roofline_frac"])
        worst_coll = max(ok, key=lambda r: r["t_collective_s"]
                         / max(1e-12, max(r["t_compute_s"], r["t_memory_s"])))
        print(f"\nworst roofline fraction: {worst_frac['arch']} x "
              f"{worst_frac['shape']} x {worst_frac['mesh']} "
              f"({worst_frac['roofline_frac']:.2%}, "
              f"dominant {worst_frac['dominant']})")
        print(f"most collective-bound: {worst_coll['arch']} x "
              f"{worst_coll['shape']} x {worst_coll['mesh']}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="results/dryrun")
    ap.add_argument("--csv", default="results/roofline.csv")
    ap.add_argument("--serving", action="store_true",
                    help="roofline the paged serving engine's KV tiers; "
                         "gates vs --serving-baseline and merges into --out")
    ap.add_argument("--serving-arch", default="qwen3-1.7b")
    ap.add_argument("--serving-steps", type=int, default=160)
    ap.add_argument("--path", default="sweep", choices=sorted(DECODE_PATHS),
                    help="decode path (sweep: the kernel-true fused sweep)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (the CPU tests' geometry)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without it) or cpu")
    ap.add_argument("--serving-baseline", default=None,
                    help="gate baseline (default: the port's own, for the "
                         "full-width or --reduced geometry)")
    ap.add_argument("--out", default="build/BENCH_serving.json",
                    help="JSON report to merge the roofline into")
    args = ap.parse_args(argv)
    if not args.serving:
        return dryrun_main(args)
    return serving_main(args)


if __name__ == "__main__":
    sys.exit(main())
