"""Paged decode on the port: assemble-then-attend vs kernel-true streaming.

  PYTHONPATH=src python -m repro_torch.benchmarks.paged_decode \
      [--arch qwen3-1.7b] [--reduced] [--device cuda] [--slots 2] \
      [--max-seq 64] [--page-tokens 8] [--requests 4] [--max-new 8]

Port of the reference's ``benchmarks/paged_decode.py``. Runs the SAME
request mix through the paged serving engine on two decode paths, like for
like, both with the decode step run eagerly (``capture_decode=False``; the
assembly path has no captured step yet):

  * assembly (``use_paged_kernel=False``): every decode step gathers the
    live slots' pages into a dense (B, S, F) view through the PUL gather
    K5, then attends: the oracle path, and what a naive paged engine does;
  * kernel-true (``use_paged_kernel=True``): attention streams pages
    straight through the PUL preload ring of the fused sweep K1, the page
    table serving as the preload trace; no dense view exists.

On the card it also runs the kernel-true path captured (its step replayed
from one CUDA graph, the engine's default), labelled as captured, whose
tokens must equal the eager kernel-true tokens bitwise.

Reports per-tick host times (the gap recording below left out), and checks
the two paths' token streams: they agree up to the first bf16 near-tie
(the two paths sum attention in other orders, so a greedy token whose
top-2 logit gap is below 2e-2 x max |logits| may flip), so the script
prints each request's first divergence with the kernel-true stream's top-2
gap there and fails on any divergence that is not a near-tie. Last, the
traffic the kernel-true path removes (modeled): the assembly path
materializes the whole B x max_seq x F packed view every step, while the
ring reads only the pages the step needs.

Without ``--reduced`` the model is the config at full width with random
weights from seed 0. ``--device`` defaults to ``cuda`` and raises without
it; ``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import DECODE_PATHS, load_model, timed_run
from repro_torch.serving import PagedEngineConfig, PagedServingEngine, Request

#: a flip is a near-tie when the stream's top-2 logit gap there is below
#: NEAR_TIE x max |logits| (the port's logits tolerance against the
#: reference)
NEAR_TIE = 2e-2


class GapEngine(PagedServingEngine):
    """The engine recording, per request, each emitted token's top-2 logit
    gap and max |logits| (``_record``, which a subclass may extend);
    ``check_s`` sums the host time the recording takes, which
    ``common.tick_s`` leaves out of the tick times."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.gaps = {}
        self.check_s = 0.0

    def _record(self, slot, logits):
        top = np.partition(np.asarray(logits, np.float64), -2)[-2:]
        self.gaps.setdefault(self.slot_req[slot].rid, []).append(
            (float(top[1] - top[0]), float(np.abs(logits).max())))

    def _emit_token(self, slot, logits):
        t0 = time.perf_counter()
        self._record(slot, logits)
        self.check_s += time.perf_counter() - t0
        super()._emit_token(slot, logits)


def run_engine(cfg, params, engine_cfg, prompts, max_new):
    """The prompts through one engine; returns (engine, per-tick host
    seconds without the gap recording, the hook's snapshots)."""
    snaps = []
    eng = GapEngine(cfg, params, engine_cfg, metrics_hook=snaps.append)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=list(p), max_new_tokens=max_new))
    return eng, [s for s, _ in timed_run(eng)], snaps


def first_divergences(want, gaps, got):
    """{rid: None or (index, top-2 gap of `want`'s stream there, its max
    |logits|)} where `got` first leaves `want`."""
    firsts = {}
    for rid, toks in sorted(want.items()):
        i = next((j for j, (a, b) in enumerate(zip(toks, got[rid]))
                  if a != b), None)
        firsts[rid] = None if i is None else (i, *gaps[rid][i])
    return firsts


def past_near_ties(firsts):
    """The divergences of `firsts` that are not near-ties: the stream's
    top-2 gap there is at least NEAR_TIE x its max |logits|."""
    return {rid: v for rid, v in firsts.items()
            if v is not None and not v[1] < NEAR_TIE * v[2]}


def compare(cfg, params, *, slots=2, max_seq=64, page_tokens=8, requests=4,
            max_new=8, seed=42, device="cuda"):
    """Both paths (and, on the card, the captured kernel-true step) over
    one request mix; prints each path's ticks and tick times, the token
    check and the modeled traffic. Returns the summary dict; raises on a
    divergence that is not a near-tie."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(3, 24))).tolist()
               for _ in range(requests)]
    base = dict(batch_slots=slots, max_seq=max_seq, page_tokens=page_tokens,
                prefill_buckets=(8, 16, 32), device=device)
    runs = {"assemble-then-attend": {**DECODE_PATHS["assembly"],
                                     "capture_decode": False},
            "kernel-true": {**DECODE_PATHS["sweep"],
                            "capture_decode": False}}
    if torch.device(device).type == "cuda":
        runs["kernel-true (captured)"] = dict(DECODE_PATHS["sweep"])
    print(f"{cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}) on "
          f"{device}: {requests} requests x {max_new} new tokens, {slots} "
          f"slots, pages of {page_tokens} tokens")

    results, summary = {}, {"paths": {}}
    for name, kw in runs.items():
        eng, times, snaps = run_engine(
            cfg, params, PagedEngineConfig(**base, **kw), prompts, max_new)
        out = {rid: r.out_tokens for rid, r in eng.requests.items()}
        steady = times[2:] or times        # drop first-call ticks
        results[name] = (eng, out, snaps)
        row = {"ticks": len(times), "decode_steps": eng.metrics.decode_steps,
               "prefills": eng.metrics.prefills,
               "tick_ms_median": statistics.median(steady) * 1e3,
               "tick_ms_p90": float(np.percentile(steady, 90)) * 1e3,
               "first_tick_ms": times[0] * 1e3}
        summary["paths"][name] = row
        print(f"  {name}: ticks {row['ticks']}, decode steps "
              f"{row['decode_steps']}, prefills {row['prefills']}; per-tick "
              f"host time median {row['tick_ms_median']:.3f} ms, p90 "
              f"{row['tick_ms_p90']:.3f} ms (first {row['first_tick_ms']:.1f}"
              " ms)")

    ea, outa, snaps = results["assemble-then-attend"]
    ek, outk, _ = results["kernel-true"]
    firsts = first_divergences(outk, ek.gaps, outa)
    same = sum(v is None for v in firsts.values())
    bad = past_near_ties(firsts)
    print(f"  token streams: {same} of {len(firsts)} requests identical; "
          "first divergence per request (index, the kernel-true stream's "
          f"top-2 gap there, its max |logits|): {firsts}")
    summary.update(identical=same, requests=len(firsts), divergences=firsts)
    if bad:
        raise AssertionError(f"kernel-true decode diverged from the assembly "
                             f"oracle past a near-tie: {bad}")
    if "kernel-true (captured)" in results:
        outc = results["kernel-true (captured)"][1]
        if outc != outk:
            raise AssertionError("the captured kernel-true step's tokens "
                                 "differ from the eager step's")
        print("  captured kernel-true tokens == eager kernel-true tokens "
              "bitwise")

    # traffic the kernel-true path removes (per decode step, modeled): the
    # assembly path materializes the WHOLE decode view; the ring reads only
    # the live working set, and overlaps those reads with compute
    page_bytes = ea.pool.page_bytes
    dense_bytes = slots * (max_seq // page_tokens) * page_bytes
    live_pages = np.mean([s["hot_pages_in_use"] for s in snaps] or [0.0])
    streamed = live_pages * page_bytes
    summary.update(dense_view_bytes=dense_bytes, page_stream_bytes=streamed,
                   preload_distance=ea.pool.distance)
    print(f"  per-step dense view materialized (assembly): "
          f"{dense_bytes / 1024:.1f} KiB (gather write + attend read)")
    print(f"  per-step page stream (kernel-true, mean over run): "
          f"{streamed / 1024:.1f} KiB read-only through the d* ring")
    print(f"  preload distance d* = {ea.pool.distance}")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (the CPU tests' geometry)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without it) or cpu")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    cfg, params, _ = load_model(args.arch, reduced=args.reduced,
                                device=args.device)
    compare(cfg, params, slots=args.slots, max_seq=args.max_seq,
            page_tokens=args.page_tokens, requests=args.requests,
            max_new=args.max_new, seed=args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
