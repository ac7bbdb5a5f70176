"""Quickstart: the PUL engine in 60 seconds, on the port.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. Plan a preload schedule analytically for the H100 (distance, expected
   utilization).
2. Run the schedule for real through the SUM kernel K8 (the hand-written
   Hopper kernel on the card, its plain version on the CPU) and check it
   against the plain sum.
3. Sweep the distance knob on the calibrated DMA twin: the paper's Fig 5.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (DMAEngine, H100_HBM, H100_SM, MICROBLAZE, NVM,
                              PULConfig, plan_stream, speedup)
from repro_torch.kernels.pul_sum import pul_sum, sum_ref


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # -- 1. plan -------------------------------------------------------
    plan = plan_stream(block_bytes=64 * 128 * 4, flops_per_block=64 * 128,
                       tier=H100_HBM, pe=H100_SM)
    print(f"planned preload distance d*={plan.cfg.distance} "
          f"(bound: {plan.bound}, predicted PE utilization "
          f"{plan.predicted_utilization:.0%})")

    # -- 2. run the real kernel against the plain sum -------------------
    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        rng.standard_normal((4096, 128), dtype=np.float32)).to(args.device)
    trace = torch.from_numpy(
        rng.integers(0, 4096, size=256, dtype=np.int32)).to(args.device)
    got = pul_sum(data, trace, cfg=PULConfig(distance=plan.cfg.distance))
    rows = data[trace.long()].double()
    # the sum cancels (|sum| << sum |x|), so an rtol says nothing: the limit
    # is a few fp32 roundings of the sum of magnitudes
    limit = 8 * 2.0 ** -24 * rows.abs().sum().item()
    err = abs(got.item() - rows.sum().item())
    assert err <= limit, f"pul_sum off the fp64 sum by {err} > {limit}"
    print(f"pul_sum(trace of 256 random rows) = {got.item():.3f} on "
          f"{data.device}; plain sum {sum_ref(data, trace).item():.3f}; "
          f"within {limit:.2e} of the fp64 sum")

    # -- 3. the paper's distance sweep (Fig 5-A) ------------------------
    eng = DMAEngine(NVM, MICROBLAZE)
    print("\ndistance sweep on the calibrated NVM twin (paper Fig 5-A):")
    for d in (1, 2, 4, 8, 16, 32):
        st = eng.run_stream(PULConfig(distance=d), n_blocks=512,
                            block_bytes=64, compute_flops_per_block=16)
        bar = "#" * int(st.pe_utilization * 40)
        print(f"  d={d:2d}  {st.total_time*1e6:7.1f} us  util {bar}")
    s = speedup(eng, PULConfig(distance=16), n_blocks=512, block_bytes=64,
                compute_flops_per_block=16)
    print(f"\ninterleaved vs phase-separated: {s:.2f}x  (paper: 2.9x on NVM)")


if __name__ == "__main__":
    main()
