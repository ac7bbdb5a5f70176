"""Every cell, configuration, traffic mix, cell file and metric reader of
``BENCHMARK.json`` is found by its name and loads; the files keep the
contract's names, units and keys; the port's configuration is built from
the published keys alone and is the port's own, and the weight layout is
the port's."""
import json
import re

import pytest
import torch

from pulbench import families, spec, weights

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + WORKLOADS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    cell = spec.cell(workload)
    assert cell.config["name"] in [c["name"] for c in BENCH["configs"]]
    assert cell.limits["logit_gap"]["limit"] is not None
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(spec.metric_reader(metric))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    cfg = spec.config(entry["name"])
    assert entry["file"] == f"pulbench/configs/{entry['name']}.json"
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    assert "port" not in cfg
    port = spec.port_config(cfg)
    fields = families.of(cfg).PORT_FIELDS
    assert fields
    for field, key in fields.items():
        assert port[field] == cfg[key], (field, key)


#: fields of the port's ModelConfig that only training reads
TRAINING_ONLY = ("train_accum", "remat", "seq_shard_carry", "bf16_moments")


def ports_own(cfg):
    """Asserts that the configuration built from `cfg`'s published keys is
    the port's own registered one (``registered`` in the file, else its
    name), field for field, but for what only training reads, and for the
    fields that the file's ``reduced`` keys give (through its family's
    ``PORT_FIELDS``), which take the file's values."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    ours = ModelConfig(**spec.port_config(cfg))
    theirs = get_config(cfg.get("registered", cfg["name"]))
    cut = {f: getattr(ours, f) for f, key in
           families.of(cfg).PORT_FIELDS.items() if key in cfg["reduced"]}
    theirs = dataclasses.replace(theirs, **cut)
    for f in dataclasses.fields(ModelConfig):
        if f.name not in TRAINING_ONLY and f.name != "name":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_port_config_is_the_ports_own(entry):
    cfg = spec.config(entry["name"])
    ports_own(cfg)
    if "registered" not in cfg:
        assert spec.port_config(cfg)["name"] == cfg["name"]


@pytest.mark.parametrize("key,value", [
    ("rope_scaling", {"type": "yarn", "factor": 4.0}),
    ("attention_bias", True), ("hidden_act", "gelu"),
    ("use_sliding_window", True)])
def test_what_the_port_does_not_compute_is_refused(key, value):
    cfg = dict(spec.config("qwen3-1.7b"), **{key: value})
    assert cfg["reference"] == "dense_gqa"
    with pytest.raises(ValueError, match=key):
        spec.port_config(cfg)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_weight_layout_is_the_ports(entry):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.module import flatten
    from repro_torch.models.transformer import model_params
    cfg = spec.config(entry["name"])
    theirs = {p: (tuple(v.shape), v.dtype) for p, v in flatten(
        model_params(ModelConfig(**spec.port_config(cfg))))}
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    ours = {p: (s, dt[d]) for p, s, d in weights.layout(spec.arch(cfg))}
    assert ours == theirs


def test_published_keys_kept():
    """qwen3-1.7b's file holds the published config's numbers and choices
    unchanged (nothing is cut)."""
    published = {
        "attention_bias": False, "head_dim": 128, "hidden_act": "silu",
        "hidden_size": 2048, "initializer_range": 0.02,
        "intermediate_size": 6144, "max_position_embeddings": 40960,
        "max_window_layers": 28, "model_type": "qwen3",
        "num_attention_heads": 16, "num_hidden_layers": 28,
        "num_key_value_heads": 8, "rms_norm_eps": 1e-06,
        "rope_scaling": None, "rope_theta": 1000000, "sliding_window": None,
        "tie_word_embeddings": True, "torch_dtype": "bfloat16",
        "use_sliding_window": False, "vocab_size": 151936}
    cfg = spec.config("qwen3-1.7b")
    assert cfg["reduced"] == []
    for k, v in published.items():
        assert cfg[k] == v, k


def test_benchmark_json_is_small():
    assert len(json.dumps(BENCH)) < 64 * 1024
