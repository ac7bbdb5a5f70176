"""A model family is two new modules and nothing else of the shared code:
a second family (the dense GQA decoder under another name), written as
files ``families/twin_gqa.py`` and ``reference/twin_gqa.py`` beside a copy
of the benchmark's files with its configuration, cell and
``BENCHMARK.json`` entries added, runs through every shared entry point
(``spec``, ``weights``, ``arith``, the metric readers, the tiny cells and
a whole tiny run) and reads as the dense family does. A configuration
whose ``reference`` names no family is refused, naming those there are."""
import dataclasses
import json
import shutil
import sys
import time

import pytest

import pulbench.families
import pulbench.reference
from pulbench import arith, families, harness, spec, weights
from pulbench.tests.test_pulbench_specs import ports_own
from pulbench.tests.test_pulbench_yardstick import SEED, TINY_LONGCTX_GAP
from pulbench.tests.tiny import tiny_cell

TWIN = "twin_gqa"
#: a module that serves `names` by the dense module's, noting each call
THROUGH = '''
CALLS = []


def _through(name):
    def call(*args, **kw):
        CALLS.append(name)
        return getattr(_dense, name)(*args, **kw)
    return call


for _name in NAMES:
    globals()[_name] = _through(_name)
'''
FAMILY = '''"""The dense GQA decoder under another name."""
from pulbench.families import dense_gqa as _dense
from pulbench.families.dense_gqa import PORT_FIELDS, TINY  # noqa: F401

NAMES = ("arch", "port_config", "layout", "active_params", "decode_flops",
         "prefill_flops", "decode_bytes", "attention_kernel_bytes")
''' + THROUGH
REFERENCE = '''"""The dense GQA decoder's reference under another name."""
from pulbench.reference import dense_gqa as _dense

NAMES = ("hidden", "head")
''' + THROUGH
CONFIG, CELL = "twin-qwen3", "twin_longctx_decode"


@pytest.fixture
def twin(tmp_path, monkeypatch):
    """The benchmark's files copied under `tmp_path`, the twin family's
    two modules and its configuration, cell and entries added there."""
    bench_dir = tmp_path / "pulbench"
    for sub in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(spec.BENCH_DIR / sub, bench_dir / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for package, source in ((pulbench.families, FAMILY),
                            (pulbench.reference, REFERENCE)):
        where = tmp_path / package.__name__.rsplit(".", 1)[1]
        where.mkdir()
        (where / f"{TWIN}.py").write_text(source)
        monkeypatch.setattr(package, "__path__",
                            [*package.__path__, str(where)])
    cfg = dict(spec.config("qwen3-1.7b"), name=CONFIG, reference=TWIN,
               registered="qwen3-1.7b")
    (bench_dir / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    shutil.copy(bench_dir / "cells" / "qwen3_longctx_decode.json",
                bench_dir / "cells" / f"{CELL}.json")
    bench = spec.benchmark()
    bench["configs"].append(dict(bench["configs"][0], name=CONFIG,
                                 file=f"pulbench/configs/{CONFIG}.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name=CELL,
                                   config=CONFIG))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "qwen3_longctx_decode" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    monkeypatch.setattr(spec, "BENCHMARK_JSON", tmp_path / "BENCHMARK.json")
    yield spec.config(CONFIG)
    for package in ("pulbench.families", "pulbench.reference"):
        sys.modules.pop(f"{package}.{TWIN}", None)


def _calls(package):
    return sys.modules[f"pulbench.{package}.{TWIN}"].CALLS


def test_second_family_is_new_files_only(twin):
    qwen = spec.config("qwen3-1.7b")
    assert TWIN in families.known() and "dense_gqa" in families.known()
    a, dense = spec.arch(twin), spec.arch(qwen)
    assert a.family == TWIN and a == dataclasses.replace(
        dense, name=CONFIG, family=TWIN)
    assert spec.port_config(twin) == dict(spec.port_config(qwen),
                                          name=CONFIG)
    ports_own(twin)
    assert weights.layout(a) == weights.layout(dense)
    assert weights.nbytes(a) == weights.nbytes(dense)
    ctx = [4143, 12148, 7]
    for f in (arith.decode_flops, arith.decode_bytes,
              arith.attention_kernel_bytes):
        assert f(a, ctx) == f(dense, ctx)
    assert arith.prefill_flops(a, 1024) == arith.prefill_flops(dense, 1024)
    assert (arith.active_params(a, head=False)
            == arith.active_params(dense, head=False))
    assert set(_calls("families")) == set(families.family(TWIN).NAMES)


def test_second_family_metric_readers(twin):
    """The readers that take the yardstick read the same of both."""
    a, dense = spec.arch(twin), spec.arch(spec.config("qwen3-1.7b"))
    ticks = [harness.Tick(0.0, 0.05, "window", 3, decode=[4143, 9000],
                          span_s=0.04),
             harness.Tick(0.05, 0.2, "window", 2, decode=[12148],
                          prefill=[1024], span_s=0.12)]
    for name in ("mfu.serve", "step_roofline.decode"):
        got = [spec.metric_reader(name)(harness.Run(
            arch=arch, peaks=arith.peaks("NVIDIA H100 80GB HBM3"),
            window_s=0.2, ticks=ticks, spans=[], counters={},
            pool_capacity=1)) for arch in (a, dense)]
        assert got[0] == got[1] and got[0] > 0
    assert {"decode_flops", "prefill_flops", "decode_bytes"} <= set(
        _calls("families"))


def test_second_family_tiny_run(twin):
    cell = tiny_cell(CELL, 0.07)
    assert cell.config["reference"] == TWIN
    assert {k: cell.config[k] for k in families.of(twin).TINY} == (
        families.family("dense_gqa").TINY)
    out = harness.run_cell(cell, SEED, 0.0, False, "cpu",
                           time.perf_counter())
    assert {"arch", "port_config", "layout"} <= set(_calls("families"))
    assert set(_calls("reference")) == {"hidden", "head"}
    assert out.correct, out.checks
    assert out.readings["logit_gap"] == TINY_LONGCTX_GAP


@pytest.mark.parametrize("name", ["no_such_family", "dense_gqa.sub",
                                  "../dense_gqa", ""])
def test_unknown_family_is_refused(name):
    cfg = dict(spec.config("qwen3-1.7b"), reference=name)
    for entry in (spec.arch, spec.port_config):
        with pytest.raises(ValueError, match="known: .*'dense_gqa'"):
            entry(cfg)
    a = dataclasses.replace(spec.arch(spec.config("qwen3-1.7b")),
                            family=name)
    for call in (lambda: weights.layout(a), lambda: weights.nbytes(a),
                 lambda: arith.decode_flops(a, [1]),
                 lambda: arith.active_params(a)):
        with pytest.raises(ValueError, match=repr(name).replace(".", r"\.")):
            call()
