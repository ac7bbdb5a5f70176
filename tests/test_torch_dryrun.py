"""The port's dry-run (``repro_torch.launch.dryrun``) and its table.

Cells of full-width qwen3-1.7b, depth cut to one layer, run on the fake
256- and 512-rank meshes in a subprocess (the fake process group never
meets the test process): each cell's per-device argument bytes equal the
arithmetic over the REFERENCE's ``cell_specs`` shard shapes, and its
counted FLOPs per device fall within ``dryrun.FLOPS_VS_ANALYTIC`` of the
analytic exec FLOPs / chips. The sweep's skipped and error cells, the ring
costs on the reference parser's cases, and the roofline table over the
records.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro.configs import CONFIGS as REF_CONFIGS
from repro.configs import SHAPES as REF_SHAPES
from repro.launch import steps as RS

from repro_torch.benchmarks import roofline
from repro_torch.benchmarks.flops import cell_cost
from repro_torch.configs import get_config, SHAPES
from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
#: the cells run for real: (shape, mesh) of full-width qwen3-1.7b, 1 layer
CELLS = (("train_4k", "single"), ("prefill_32k", "single"),
         ("decode_32k", "single"), ("decode_32k", "multi"))

_RUN = """
import json, sys
from repro_torch.launch import dryrun as D
out = [D.dryrun_cell("qwen3-1.7b", s, multi_pod=m == "multi", groups=1,
                     verbose=False) for s, m in json.loads(sys.argv[1])]
import torch.distributed as dist
assert not dist.is_initialized()      # every fake group was destroyed
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(scope="module")
def records():
    proc = subprocess.run([sys.executable, "-c", _RUN, json.dumps(CELLS)],
                          env=_env(), cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    return {(r["shape"], r["mesh"]): r for r in rows}


def _ref_argument_bytes(shape_name, mesh_name):
    """Local bytes of the reference's cell inputs (one layer), from its
    specs: each tensor dim divided by the mesh axes its spec names."""
    rcfg = dataclasses.replace(REF_CONFIGS["qwen3-1.7b"], num_layers=1)
    sizes = MESHES[mesh_name]
    cell = RS.cell_specs(rcfg, REF_SHAPES[shape_name],
                         SimpleNamespace(shape=sizes))
    total = 0
    for a, s in (("params", "param_specs"), ("opt", "opt_specs"),
                 ("batch", "batch_specs"), ("caches", "cache_specs")):
        if a not in cell:
            continue
        stack = [(cell[a], cell[s])]
        while stack:
            x, spec = stack.pop()
            if isinstance(x, dict):
                stack.extend((x[k], spec[k]) for k in x)
                continue
            dims = list(x.shape)
            for i, entry in enumerate(spec):
                names = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                dims[i] //= math.prod(sizes[n] for n in names)
            total += math.prod(dims) * x.dtype.itemsize
    return total


@pytest.mark.parametrize("shape,mesh", CELLS)
def test_cell_ok_and_argument_bytes_match_reference(records, shape, mesh):
    r = records[(shape, mesh)]
    assert r["status"] == "ok"
    assert r["chips"] == (512 if mesh == "multi" else 256)
    assert r["num_layers"] == 1
    assert r["collectives_counted"] == "dynamic"
    assert r["argument_bytes_per_dev"] == _ref_argument_bytes(shape, mesh)
    assert r["argument_bytes_per_dev"] == D.argument_bytes_per_dev(
        D.S.cell_specs(D.cut_depth(get_config("qwen3-1.7b"), 1),
                       SHAPES[shape], SimpleNamespace(shape=MESHES[mesh])),
        SimpleNamespace(shape=MESHES[mesh]))


@pytest.mark.parametrize("shape,mesh", CELLS)
def test_cell_flops_per_device_near_the_analytic_count(records, shape, mesh):
    """The counted FLOPs of rank 0's local shards against cell_cost's exec
    FLOPs / chips, within FLOPS_VS_ANALYTIC (its reasons are beside it);
    the prefill cell, all matmuls split evenly, matches it to 1e-4."""
    r = records[(shape, mesh)]
    cfg = D.cut_depth(get_config("qwen3-1.7b"), 1)
    want = cell_cost(cfg, SHAPES[shape], accum=r["accum"] or 0).exec_flops \
        / r["chips"]
    lo, hi = D.FLOPS_VS_ANALYTIC
    assert lo <= r["flops_per_dev"] / want <= hi
    if shape == "prefill_32k":
        assert r["flops_per_dev"] == pytest.approx(want, rel=1e-4)


def test_cell_memory_and_collectives_are_counted(records):
    for r in records.values():
        assert r["temp_bytes_per_dev"] > 0
        assert r["peak_bytes_per_dev"] == (r["temp_bytes_per_dev"]
                                           + r["argument_bytes_per_dev"])
        assert r["collective_bytes_per_dev"] == sum(
            r["collective_kinds"].values())
        assert r["collective_bytes_per_dev"] > 0
    # the train step's FSDP gathers and gradient reductions both run
    assert {"all-gather", "reduce-scatter"} <= set(
        records[("train_4k", "single")]["collective_kinds"])


def test_roofline_table_reads_the_records(records, tmp_path):
    for r in records.values():
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json"
         ).write_text(json.dumps(r))
    (tmp_path / "qwen3-1.7b__long_500k__single.json").write_text(json.dumps(
        D.dryrun_cell("qwen3-1.7b", "long_500k", multi_pod=False)))
    rows = roofline.analyze(str(tmp_path))
    assert len(rows) == len(records) + 1
    ok = [r for r in rows if r["status"] == "ok"]
    assert len(ok) == len(records)
    for r in ok:
        rec = records[(r["shape"], r["mesh"])]
        assert r["t_collective_s"] == pytest.approx(
            rec["collective_bytes_per_dev"] / roofline.NVLINK_BW)
        assert r["t_compute_s"] == pytest.approx(
            r["exec_flops"] / (r["chips"] * roofline.PEAK_BF16))
    md = roofline.to_markdown(rows)
    assert md.count("\n") == len(rows) + 1 and "skipped" in md
    csv = tmp_path / "roofline.csv"
    assert roofline.main(["--dryrun-dir", str(tmp_path),
                          "--csv", str(csv)]) == 0
    assert csv.read_text().count("\n") == len(ok) + 1


def test_skipped_cell_needs_no_mesh():
    r = D.dryrun_cell("qwen3-1.7b", "long_500k", multi_pod=True)
    assert r["status"] == "skipped" and "sub-quadratic" in r["reason"]


def test_sweep_records_error_cells_and_exits_1(monkeypatch, tmp_path):
    """--all: an exception becomes an error cell with its type and message,
    the sweep goes on and exits 1; a cached cell is not run again."""
    ran = []

    def cell(arch, shape_name, *, multi_pod, **kw):
        ran.append((arch, shape_name, multi_pod))
        if shape_name == "prefill_32k" and multi_pod:
            raise NotImplementedError("no strategy for aten.op")
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single", "status": "ok"}

    monkeypatch.setattr(D, "dryrun_cell", cell)
    (tmp_path / "qwen3-1.7b__train_4k__single.json").write_text("{}")
    rc = D.main(["--all", "--arch", "qwen3-1.7b", "--out", str(tmp_path)])
    assert rc == 1
    assert ("qwen3-1.7b", "train_4k", False) not in ran
    assert len(ran) == 2 * len(SHAPES) - 1
    err = json.loads(
        (tmp_path / "qwen3-1.7b__prefill_32k__multi.json").read_text())
    assert err == {"arch": "qwen3-1.7b", "shape": "prefill_32k",
                   "mesh": "multi", "status": "error",
                   "error": "NotImplementedError: no strategy for aten.op"}
    assert len(list(tmp_path.glob("*.json"))) == 2 * len(SHAPES)


@pytest.mark.parametrize("exc", [KeyboardInterrupt, SystemExit])
def test_sweep_reraises_interrupts(monkeypatch, tmp_path, exc):
    def cell(*a, **kw):
        raise exc()
    monkeypatch.setattr(D, "dryrun_cell", cell)
    with pytest.raises(exc):
        D.main(["--all", "--arch", "qwen3-1.7b", "--out", str(tmp_path)])
    assert not list(tmp_path.glob("*.json"))


@pytest.mark.parametrize("kind,rb,g,want", [
    # the reference parser's cases (tests/test_system.py)
    ("all-gather", 256 * 4096 * 2, 16, 256 * 4096 * 2 * 15 / 16),
    ("all-reduce", 1024 * 4, 256, 1024 * 4 * 2 * 255 / 256),
    ("collective-permute", 128 * 128 * 2, 2, 128 * 128 * 2),
    ("reduce-scatter", 1000, 16, 1000 * 15),
    ("all-to-all", 1024, 4, 1024 * 3 / 4),
    ("all-reduce", 4096, 1, 0),
])
def test_ring_bytes(kind, rb, g, want):
    assert D.ring_bytes(kind, rb, g) == want


def test_variant_rules_are_the_references():
    assert D.variant_rules("", "decode") is None
    assert D.variant_rules("serve_replicate", "train") is None
    assert D.variant_rules("serve_replicate", "decode").rules["embed"] \
        == (None,)
    assert D.variant_rules("serve_fsdp", "decode").rules["embed"] \
        == (("pod", "data"), "data", None)
    assert D.variant_rules("cache_seq_data", "train").rules["cache_seq"] \
        == ("data", None)
