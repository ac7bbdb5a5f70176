"""Finding things by name: the cells of ``BENCHMARK.json`` and the files of
each configuration, traffic mix, cell and per-layer metric under
``pulbench/``.

    configs/<config>.json     a configuration: the published config's keys,
                              what was cut, its reference's family
    traffic/<traffic>.json    a traffic mix's parameters (``traffic.py``)
    cells/<workload>.json     a cell's correctness limits and their readings
    metrics/<metric>.py       a per-layer metric's reader, ``read(run)``

Nothing here imports the port or torch.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

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
# a configuration's widths, read from the published config's own keys
# ------------------------------------------------------------------------ #
#: the port's row padding of the vocabulary (``ModelConfig.vocab_chunk``),
#: which the weight layout follows
VOCAB_CHUNK = 16384


@dataclasses.dataclass(frozen=True)
class Arch:
    """The widths of one configuration as the benchmark reads them (the
    published config's keys), and the port's padded table rows."""

    name: str
    family: str                 # the reference's module: "dense_gqa"
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    vocab_rows: int             # the port's table rows (vocab padded)
    tied: bool
    rope_theta: float
    eps: float
    qk_norm: bool
    init_std: float             # the config's initializer_range

    @property
    def kv_row_bytes(self) -> int:
        """Bytes of one cached token over all layers (bf16)."""
        return self.layers * 2 * self.kv_heads * self.head_dim * 2


def _dense_gqa(cfg: Dict[str, Any]) -> None:
    """Raises where the published config asks for what the port's dense
    decoder does not compute."""
    unsupported = {
        "hidden_act": cfg.get("hidden_act", "silu") != "silu",
        "attention_bias": bool(cfg.get("attention_bias", False)),
        "rope_scaling": cfg.get("rope_scaling") is not None,
        "use_sliding_window": bool(cfg.get("use_sliding_window", False)),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"{cfg['name']}: the port's dense decoder does not "
                         f"compute {bad}")


def arch(cfg: Dict[str, Any]) -> Arch:
    if cfg["reference"] != "dense_gqa":
        raise ValueError(f"{cfg['name']}: no reference family "
                         f"{cfg['reference']!r}")
    _dense_gqa(cfg)
    vocab = cfg["vocab_size"]
    return Arch(
        name=cfg["name"], family=cfg["reference"], d=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab=vocab,
        vocab_rows=math.ceil(vocab / VOCAB_CHUNK) * VOCAB_CHUNK,
        tied=bool(cfg.get("tie_word_embeddings", False)),
        rope_theta=float(cfg["rope_theta"]), eps=float(cfg["rms_norm_eps"]),
        qk_norm=cfg.get("model_type") == "qwen3",
        init_std=float(cfg.get("initializer_range", 0.02)))


def port_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The keyword arguments of the port's ``ModelConfig`` for `cfg`, from
    the published keys alone (the same that ``arch`` reads)."""
    a = arch(cfg)
    return dict(
        name=a.name, family="dense", num_layers=a.layers, d_model=a.d,
        num_heads=a.heads, num_kv_heads=a.kv_heads, head_dim=a.head_dim,
        d_ff=a.d_ff, vocab_size=a.vocab, pattern=("global",),
        mlp_type="swiglu", qk_norm=a.qk_norm, rope_theta=a.rope_theta,
        tie_embeddings=a.tied, norm_eps=a.eps, vocab_chunk=VOCAB_CHUNK)
