"""The result's last line carries exactly the contract's keys (and the
checks, last); a run without a CUDA card, or without the port beside the
benchmark, fails and prints no result."""
import json
import shutil
import subprocess
import sys
import time

import pytest

from pulbench import harness, spec
from pulbench.tests.tiny import tiny_cell

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(traced):
    out = harness.run_cell(tiny_cell("qwen3_longctx_decode"), 2**31 + 3,
                           0.0, traced, "cpu", time.perf_counter())
    line = json.loads(json.dumps(out.line()))
    keys = list(line)
    assert keys[:5] == REQUIRED and keys[-1] == "checks"
    assert set(keys) <= set(REQUIRED) | {"breakdown", "checks"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"] for m in spec.cell("qwen3_longctx_decode").end_to_end}
    if not traced:
        assert set(line["metrics"]) == want


def _run(cwd):
    return subprocess.run(
        [sys.executable, "-m", "pulbench.run", "--workload",
         "qwen3_longctx_decode", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run(spec.ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(spec.BENCHMARK_JSON, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "pulbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
