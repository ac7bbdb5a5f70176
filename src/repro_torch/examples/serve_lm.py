"""Paged-KV serving example on the port: continuous batching.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm \
      [--arch qwen3-1.7b] [--reduced] [--device cuda] [--requests 6] \
      [--max-new 10] [serving flags of ServingConfig.add_flags]

Port of the reference's ``examples/serve_lm.py``. Spins up the paged engine,
submits a burst of requests with different lengths (two sharing a
page-aligned prompt prefix, so their prompt pages are physically shared),
preempts one mid-stream to push its pages through the cold tier, resumes
it, and checks that every request finished, that the prefix pages were
shared and that the victim's pages were evicted and restored. A model
without pageable KV (rwkv6-7b) keeps only recurrent state, which no page
holds: there the page checks do not apply, and the preempted request's
state is snapshotted and written back instead.

The shared flag surface (``ServingConfig.add_flags``) picks the device and
the decode path (kernel-true fused sweep by default); the example layers
its own tighter geometry on top (3 slots of 96 tokens, 8-token pages).
Without ``--reduced`` the model is the config at full width with random
weights from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving import PagedServingEngine, Request, ServingConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=10)
    ServingConfig.add_flags(ap)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    serving_cfg = ServingConfig.from_flags(args)
    params = init_params(cfg, seed=0, device=serving_cfg.device)
    # the shared flag surface, with this example's tighter defaults layered
    # on top (3 slots, small pages, a bucket ladder that starts at one page)
    eng = PagedServingEngine(cfg, params, dataclasses.replace(
        serving_cfg, batch_slots=3, max_seq=96, page_tokens=8,
        prefill_buckets=(8, 16, 32)))
    print(f"[serve_lm] paged engine on {eng.device}: {eng.layout.features} "
          f"KV features/token, planned restore distance d*={eng.pool.distance}")

    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, size=8).tolist()   # 1 full page
    reqs = []
    for i in range(args.requests):
        if i < 2:       # two requests share an 8-token (page-aligned) prefix
            prompt = shared + rng.integers(
                1, cfg.vocab_size, size=rng.integers(1, 6)).tolist()
        else:
            prompt = rng.integers(1, cfg.vocab_size,
                                  size=rng.integers(3, 12)).tolist()
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=args.max_new))
    t0 = time.time()
    for r in reqs:
        eng.submit(r)
    # let the first batch decode a little, then swap one slot out and back
    for _ in range(4):
        eng.step()
    victim = next((i for i, r in enumerate(eng.slot_req) if r is not None),
                  None)
    if victim is not None:
        eng.preempt(victim)
        eng.step()
        eng.resume(victim)
    out = eng.run()
    dt = time.time() - t0
    for rid in sorted(out):
        print(f"[serve_lm] req {rid}: +{len(out[rid])} tokens -> {out[rid]}")
    total = sum(len(v) for v in out.values())
    snap = eng.snapshot()
    print(f"[serve_lm] {total} tokens, {total / dt:.1f} tok/s "
          f"({args.requests} reqs over 3 slots)")
    print(f"[serve_lm] pages: {snap['pages_allocated']} allocated, "
          f"{snap['shared_page_hits']} prefix-shared, "
          f"{snap['evictions']} evicted, {snap['page_faults']} restored")
    assert all(len(v) == args.max_new for v in out.values())
    if eng.layout.features:
        assert snap["shared_page_hits"] >= 1, "prefix pages should be shared"
        if victim is not None:
            assert snap["evictions"] >= 1 and snap["page_faults"] >= 1
    return out, snap


if __name__ == "__main__":
    main()
