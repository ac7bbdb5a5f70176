"""Benchmark entry point of the port: the paper's figures, one section each.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]

Prints the `name,value,derived` CSV rows of each figure and the paper-claim
PASS/FAIL lines, and exits 1 when a claim fails. The kernels run on
`--device` (default `cuda`: the hand-written Hopper kernels; `cpu`: their
plain versions). The reference's roofline section reads dry-run artifacts;
the dry-run is not ported yet, and this says so.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the kernels' tensors (cuda or cpu)")
    args = ap.parse_args(argv)

    t0 = time.time()
    from repro_torch.benchmarks import paper_experiments as P

    device = torch.device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    rows, claims = P.run_all(device=args.device)
    print("name,value,derived")
    for r in rows:
        print(r)
    print()
    failed = 0
    for c in claims:
        print(c)
        failed += ("FAIL" in c)
    print(f"\n[bench] {len(rows)} rows, {len(claims)} claims "
          f"({failed} failed) in {time.time()-t0:.1f}s; kernels on {name}")

    print("\n[bench] roofline: the dry-run that feeds it is not ported yet "
          "(ROADMAP.md, port queue item 14)")
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
