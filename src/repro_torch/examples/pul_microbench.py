"""PUL microbenchmark playground: the paper's figures, interactively, on the
port.

  PYTHONPATH=src python -m repro_torch.examples.pul_microbench [--device cpu]

Sweeps the three PUL knobs (distance, transfer size, issue strategy) on the
calibrated DMA twin for every memory tier (the paper's DRAM and NVM with its
MicroBlaze PE; the H100's HBM and pinned host memory with one SM as the
PE), prints the paper-style summary, and validates each swept configuration
through the PUL gather K5 (the hand-written Hopper kernel on the card, its
plain version on the CPU).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (DMAEngine, DRAM, H100_HBM, H100_PINNED_HOST,
                              H100_SM, MICROBLAZE, NVM, IssueStrategy,
                              PULConfig, plan_stream)
from repro_torch.kernels.pul_gather import gather_ref, pul_gather

TIERS = [("dram", DRAM, MICROBLAZE), ("nvm", NVM, MICROBLAZE),
         ("h100_hbm", H100_HBM, H100_SM),
         ("h100_pinned_host", H100_PINNED_HOST, H100_SM)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"{'tier':18s}{'d*':>4s}{'bound':>11s}{'util@d*':>9s}"
          f"{'speedup':>9s}")
    for name, tier, pe in TIERS:
        eng = DMAEngine(tier, pe)
        blk = 8192 if pe is H100_SM else 64
        fl = blk // 4
        plan = plan_stream(block_bytes=blk, flops_per_block=fl, tier=tier,
                           pe=pe)
        kw = dict(n_blocks=256, block_bytes=blk, compute_flops_per_block=fl)
        st = eng.run_stream(plan.cfg, **kw)
        base = eng.run_stream(plan.cfg, interleave=False, **kw)
        print(f"{name:18s}{plan.cfg.distance:4d}{plan.bound:>11s}"
              f"{st.pe_utilization:9.2f}{base.total_time/st.total_time:9.2f}x")

    print("\ntransfer-size sweep on NVM (paper Fig 6):")
    eng = DMAEngine(NVM, MICROBLAZE)
    for size in (64, 256, 1024, 4096):
        st = eng.run_stream(PULConfig(distance=16), n_blocks=512,
                            block_bytes=size,
                            compute_flops_per_block=size // 4)
        print(f"  {size:5d}B  bw {st.io_throughput/2**20:8.1f} MiB/s  "
              f"util {st.pe_utilization:.2f}")

    print("\nbatch vs sequential issue (paper Fig 5-D):")
    for d in (2, 4, 8, 16):
        kw = dict(n_blocks=512, block_bytes=64, compute_flops_per_block=16)
        tb = eng.run_stream(PULConfig(distance=d), **kw).total_time
        ts = eng.run_stream(PULConfig(distance=d,
                                      strategy=IssueStrategy.SEQUENTIAL),
                            **kw).total_time
        print(f"  d={d:2d}  batch {tb*1e6:7.1f} us   sequential "
              f"{ts*1e6:7.1f} us")

    # functional cross-check through the real kernel at every knob
    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        rng.standard_normal((512, 128), dtype=np.float32)).to(args.device)
    trace = torch.from_numpy(
        rng.integers(0, 512, size=64, dtype=np.int32)).to(args.device)
    want = gather_ref(table, trace)
    for d in (1, 4, 16):
        for strat in IssueStrategy:
            got = pul_gather(table, trace,
                             cfg=PULConfig(distance=d, strategy=strat))
            if not torch.equal(got, want):
                raise AssertionError(f"pul_gather d={d} {strat.name} differs "
                                     "from the plain gather")
    print(f"\nall swept configs validated through the PUL gather on "
          f"{table.device}")


if __name__ == "__main__":
    main()
