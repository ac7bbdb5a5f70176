"""The port's sharding layer against the reference's, leaf by leaf.

Both packages resolve on stub meshes ({axis: size} dicts, no devices): the
resolver's cases, every arch's parameter specs, and ``cell_specs`` for
every arch x applicable shape x sharding variant x mesh (params, optimizer
state, batch and caches: spec, shape and dtype of each leaf). A spec of the
port is a tuple; the reference's ``PartitionSpec`` is turned into one.
The placements of a tuple axis are checked on a real ``DeviceMesh`` over a
``fake`` process group, in a subprocess, rank by rank; and a 1x1 mesh
(gloo) computes the same bits as no mesh, for six reduced archs.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import CONFIGS as REF_CONFIGS
from repro.configs import SHAPES as REF_SHAPES
from repro.launch import steps as RS
from repro.models import build_model as ref_build_model
from repro.models import module as RM
from repro.runtime.sharding import ShardingRules as RefRules
from repro.runtime.sharding import logical_to_spec as ref_logical_to_spec

from repro_torch.configs import CONFIGS, SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps as S
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.models import zoo
from repro_torch.runtime import sharding as SH

ROOT = Path(__file__).resolve().parent.parent


class _StubMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"single": _StubMesh({"data": 16, "model": 16}),
          "multi": _StubMesh({"pod": 2, "data": 16, "model": 16})}
VARIANTS = ("default", "serve_replicate", "serve_fsdp", "cache_seq_data")


def _flat(tree, is_leaf, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and not is_leaf(v):
            out.update(_flat(v, is_leaf, path))
        else:
            out[path] = v
    return out


def _ref_specs(tree):
    return {k: tuple(v) for k, v in
            _flat(tree, lambda x: isinstance(x, P)).items()}


def _port_specs(tree):
    return _flat(tree, lambda x: False)


def _dtype_name(x):
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    return jnp.dtype(x).name


def _ref_abstract(tree):
    return {k: (tuple(v.shape), _dtype_name(v.dtype))
            for k, v in _flat(tree, lambda x: hasattr(x, "shape")).items()}


def _port_abstract(tree):
    out = {}
    for k, v in _port_specs(tree).items():
        assert v.device.type == "meta", k       # nothing allocated
        out[k] = (tuple(v.shape), _dtype_name(v.dtype))
    return out


def _ref_rules(variant, kind):
    """The reference dry-run's variant rules (``repro/launch/dryrun.py``;
    that module sets XLA_FLAGS at import, so its logic is restated)."""
    if variant == "serve_replicate" and kind != "train":
        return RefRules().with_overrides(embed=(None,))
    if variant == "serve_fsdp":
        return RefRules()
    if variant == "cache_seq_data":
        return RefRules().with_overrides(cache_seq=("data", None))
    return None


# ------------------------------------------------------------ the resolver
@pytest.mark.parametrize("logical,dims,mesh,want", [
    (("embed", "ff"), (4096, 16384), "multi", (("pod", "data"), "model")),
    (("embed", "heads", "head_dim"), (5120, 40, 128), "multi",
     (("pod", "data"),)),
    (("embed", "heads", "head_dim"), (6144, 48, 128), "multi",
     (("pod", "data"), "model")),
    (("cache_batch", "cache_seq", "act_kv_heads", None),
     (128, 32768, 8, 128), "multi", (("pod", "data"), "model")),
    (("embed", "ff"), (4096, 16384), "single", ("data", "model")),
], ids=["2d-weight", "40-heads-replicate", "48-heads", "no-axis-reuse",
        "single-pod-skips-pod"])
def test_resolver_cases_match_reference(logical, dims, mesh, want):
    """The reference's resolver cases (tests/test_substrate.py): the
    basic 2D weight, the divisibility fallback, no mesh axis used twice,
    the single-pod mesh skipping "pod"."""
    got = SH.logical_to_spec(logical, dims, MESHES[mesh])
    assert got == want
    assert got == tuple(ref_logical_to_spec(logical, dims, MESHES[mesh]))


def test_resolver_rejects_rank_mismatch():
    with pytest.raises(ValueError):
        SH.logical_to_spec(("embed",), (4, 4), MESHES["single"])


def test_rules_with_overrides_keeps_the_rest():
    r = SH.ShardingRules().with_overrides(embed=(None,))
    assert r.rules["embed"] == (None,)
    assert r.rules["ff"] == SH.DEFAULT_RULES["ff"]
    assert SH.DEFAULT_RULES == RefRules().rules


# ------------------------------------------------------------ param specs
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_param_specs_match_reference(arch, mesh):
    ref = _ref_specs(RM.param_specs(ref_build_model(REF_CONFIGS[arch]).params,
                                    MESHES[mesh]))
    got = _port_specs(M.param_specs(T.model_params(CONFIGS[arch]),
                                    MESHES[mesh]))
    assert got == ref


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_count_bytes_and_abstract_state_match_reference(arch):
    cfg, rcfg = CONFIGS[arch], REF_CONFIGS[arch]
    tree = T.model_params(cfg)
    assert M.count_bytes(tree) == RM.count_bytes(ref_build_model(rcfg).params)
    assert M.count_bytes(tree) == sum(
        p.size * p.dtype.itemsize for _, p in M.flatten(tree))
    rparams, ropt = RS.abstract_state(rcfg)
    params, opt = S.abstract_state(cfg)
    assert _port_abstract(params) == _ref_abstract(rparams)
    assert _port_abstract(opt) == _ref_abstract(ropt)
    assert _port_abstract(zoo.Model(cfg, {}).abstract_params()) \
        == _ref_abstract(ref_build_model(rcfg).abstract_params())
    is_axes = lambda x: isinstance(x, tuple)
    assert _flat(M.logical_tree(tree), is_axes) == _flat(
        RM.logical_tree(ref_build_model(rcfg).params), is_axes)


# ------------------------------------------------------------ cell specs
def _cells():
    return [(a, s, m) for a in sorted(CONFIGS) for s in SHAPES
            for m in sorted(MESHES)]


@pytest.mark.parametrize("arch,shape,mesh", _cells())
def test_cell_specs_match_reference(arch, shape, mesh):
    """Every leaf of cell_specs (params, opt, batch, caches: spec, shape,
    dtype) equals the reference's, under each sharding variant; the
    inapplicable cells are the reference's."""
    cfg, rcfg = CONFIGS[arch], REF_CONFIGS[arch]
    sh, rsh = SHAPES[shape], REF_SHAPES[shape]
    assert cfg.shape_applicable(sh) == rcfg.shape_applicable(rsh)
    if not cfg.shape_applicable(sh):
        return
    for variant in VARIANTS:
        rules = D.variant_rules(variant, sh.kind)
        rrules = _ref_rules(variant, rsh.kind)
        assert (rules is None) == (rrules is None)
        got = S.cell_specs(cfg, sh, MESHES[mesh], rules)
        ref = RS.cell_specs(rcfg, rsh, MESHES[mesh], rrules)
        assert sorted(got) == sorted(ref), variant
        for key in got:
            if key.endswith("specs"):
                assert _port_specs(got[key]) == _ref_specs(ref[key]), \
                    (variant, key)
            else:
                assert _port_abstract(got[key]) == _ref_abstract(ref[key]), \
                    (variant, key)


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_cache_specs_pair_matches_reference(arch):
    """Model.cache_specs is the reference's (shapes, logical axes) pair;
    transformer.cache_specs keeps its (shape, dtype) leaves."""
    cfg, rcfg = CONFIGS[arch], REF_CONFIGS[arch]
    spec, logical = zoo.Model(cfg, {}).cache_specs(4, 64)
    rspec, rlogical = ref_build_model(rcfg).cache_specs(4, 64)
    assert spec == T.cache_specs(cfg, 4, 64)
    assert {k: (tuple(v[0]), _dtype_name(v[1])) for k, v in
            _flat(spec, lambda x: isinstance(x, tuple)).items()} \
        == _ref_abstract(rspec)
    assert _flat(logical, lambda x: isinstance(x, tuple)) == _flat(
        rlogical, lambda x: isinstance(x, tuple))


def test_serve_replicate_rule_by_bytes_per_model_shard():
    """Inference cells replicate weights over the data axes when
    count_bytes / tp fits SERVE_REPLICATE_LIMIT, as the reference decides:
    qwen3 replicates its "embed" dims, grok keeps FSDP."""
    assert S.SERVE_REPLICATE_LIMIT == RS.SERVE_REPLICATE_LIMIT
    mesh = MESHES["single"]
    small = S.cell_specs(CONFIGS["qwen3-1.7b"], SHAPES["decode_32k"], mesh)
    big = S.cell_specs(CONFIGS["grok-1-314b"], SHAPES["decode_32k"], mesh)
    assert small["param_specs"]["embedding"]["table"] == ("model",)
    assert big["param_specs"]["embedding"]["table"] == ("model", "data")


# ------------------------------------------------------------ placements
_PLACEMENT_PROBE = r"""
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch.launch.mesh import _mesh
from repro_torch.runtime import sharding as SH
shape = (16, 6, 3)
spec = (("pod", "data"), "model")
out = []
for rank in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
    mesh = _mesh("cpu", (2, 2, 2), ("pod", "data", "model"))
    pl = SH.placements(spec, mesh)
    ls, off = compute_local_shape_and_global_offset(shape, mesh, pl)
    out.append({"rank": rank, "coord": mesh.get_coordinate(),
                "placements": [repr(p) for p in pl],
                "local": list(ls), "offset": list(off),
                "local_shape": list(SH.local_shape(shape, spec, mesh))})
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_placements_of_a_tuple_axis_local_shapes_and_offsets():
    """("pod", "data") on dim 0 shards it over both mesh dims, pod the
    major one, as JAX lays it out: the device at (p, d, m) of a (2, 2, 2)
    mesh holds rows (2p + d) * 4 ... + 4 and columns 3m ... + 3."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PLACEMENT_PROBE], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(rows) == 8
    for r in rows:
        p, d, m = r["coord"]
        assert r["placements"] == ["Shard(dim=0)", "Shard(dim=0)",
                                   "Shard(dim=1)"]
        assert r["local"] == [4, 3, 3] == r["local_shape"]
        assert r["offset"] == [(2 * p + d) * 4, 3 * m, 0]


def test_placements_replicate_over_a_one_device_mesh_dim():
    """A mesh dim of one device splits nothing: it takes Replicate, and
    a dim of more devices still takes its Shard."""
    from torch.distributed.tensor import Replicate, Shard
    from types import SimpleNamespace

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 4))
    assert SH.placements(("data", "model"), mesh) == [Replicate(), Shard(1)]
    one = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    assert SH.placements(("data", "model"), one) == [Replicate()] * 2


def test_placements_reject_tuple_against_mesh_order():
    class _Names:
        mesh_dim_names = ("pod", "data", "model")
    with pytest.raises(ValueError):
        SH.placements((("data", "pod"),), _Names())


# ------------------------------------------------------------ constrain
def test_constrain_outside_a_mesh_returns_the_same_object():
    x = torch.arange(6.0).reshape(2, 3)
    assert SH.current_mesh() is None
    assert SH.constrain(x, ("batch", None)) is x
    # even when the logical axes would not match the rank: no work is done
    assert SH.constrain(x, ("batch",)) is x


def test_set_mesh_restores_the_previous_mesh():
    sentinel = object()
    with SH.set_mesh(sentinel):
        assert SH.current_mesh() is sentinel
        with SH.set_mesh(None):
            assert SH.current_mesh() is None
        assert SH.current_mesh() is sentinel
    assert SH.current_mesh() is None


@pytest.mark.parametrize("arch,prompt", [
    ("qwen3-1.7b", 2304), ("gemma2-27b", 2304), ("musicgen-large", 256),
    ("grok-1-314b", 256), ("rwkv6-7b", 256), ("zamba2-7b", 256)])
def test_one_by_one_mesh_is_bitwise_no_mesh(arch, prompt):
    """The reduced model's prefill (streamed attention at 2304 tokens),
    one decode step and a two-micro-batch training step on a 1x1 mesh over
    a one-rank gloo group, the inputs DTensors and every ``constrain`` a
    redistribute: 0 elements differ from the run without a mesh. No mesh
    route is taken here (they key on a dim split over more than one
    device); tests/test_torch_mesh_parity.py runs them on wider meshes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mesh_parity", "--arch",
         arch, "--device", "cpu", "--reduced", "--prompt", str(prompt)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["differing"] and not any(out["differing"].values())
