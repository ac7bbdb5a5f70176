"""Run one cell of the benchmark and print its result as the last line.

    python3 -m pulbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

from the root of a checkout. With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device's
busy and traced seconds and a breakdown. Exits non-zero, printing no
result, without a CUDA card (or fewer cards than the cell asks for), when
the port is not beside this folder, and when JAX or the JAX package is
loaded once the window has closed.
"""
from __future__ import annotations

import time

_IMPORTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from pulbench import spec  # noqa: E402

#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (from
    /proc/self/stat, to the clock tick; where that is not readable, the
    moment this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


def forbidden_modules():
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="judge the tokens that the fp8 control puts first "
                        "in place of the served ones (comes out not correct)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    started = process_start()
    args = _parse(argv)
    cell = spec.cell(args.workload)
    src = spec.ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"pulbench: the port (src/repro_torch) is not in {spec.ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    from pulbench.harness import run_cell
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"pulbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   started, control=bool(args.control))
    found = forbidden_modules()
    if found:
        print(f"pulbench: loaded in this run: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in out.checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    line = out.line()
    if not all(math.isfinite(m["value"]) for m in line["metrics"].values()):
        print(f"pulbench: a metric is not finite: {line['metrics']}",
              file=sys.stderr)
        return 5
    print(json.dumps(line, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
