"""Finding things by name: the cells of ``BENCHMARK.json`` and the files of
each configuration, traffic mix, cell and per-layer metric under
``pulbench/``.

    configs/<config>.json     a configuration: the published config's keys,
                              what was cut, its reference's family
    traffic/<traffic>.json    a traffic mix's parameters (``traffic.py``)
    cells/<workload>.json     a cell's correctness limits and their readings
    metrics/<metric>.py       a per-layer metric's reader, ``read(run)``
    families/<family>.py      a family's widths, weight layout and yardstick
    reference/<family>.py     a family's plain reference

Nothing here imports the port or torch.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from pulbench import families

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(BENCHMARK_JSON)


def config(name: str) -> Dict[str, Any]:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> Dict[str, Any]:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def cell_limits(workload: str) -> Dict[str, Any]:
    return load_json(BENCH_DIR / "cells" / f"{workload}.json")


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """The ``read`` function of ``metrics/<name>.py`` (loaded by path: a
    metric's name may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_name = "pulbench.metrics._" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]     # the metrics this cell reports
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = bench if bench is not None else benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    return Cell(
        name=workload, config=config(entry["config"]),
        traffic=traffic(entry["traffic"]), limits=cell_limits(workload),
        chips=entry["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


# ------------------------------------------------------------------------ #
# a configuration's widths and the port's configuration, by its family
# ------------------------------------------------------------------------ #
#: the dense family's widths (``families/dense_gqa.py``), under their old name
Arch = families.family("dense_gqa").Arch


def arch(cfg: Dict[str, Any]) -> Any:
    """The widths of `cfg`, read by its family (``families/<reference>.py``)
    from the published config's own keys. What shared code may read of
    them is listed in ``families/__init__.py``."""
    return families.of(cfg).arch(cfg)


def port_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The keyword arguments of the port's ``ModelConfig`` for `cfg`, from
    the published keys alone (the same that ``arch`` reads)."""
    return families.of(cfg).port_config(cfg)
