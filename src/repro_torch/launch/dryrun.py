"""Dry-run of the port: every (arch x shape x mesh) cell's step, run on a
fake mesh (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step for 256 or 512 placeholder
devices and reads XLA's memory analysis, cost analysis and collective
schedule. Here the cell's step runs once, eagerly, on a ``DeviceMesh`` over a
``fake`` process group of 256 ranks ((16, 16) over ("data", "model")) or 512
((2, 16, 16) over ("pod", "data", "model")), this process playing rank 0:

  * the inputs (params, optimizer state, batch, caches) are DTensors laid
    out by ``steps.cell_specs``, their local shards fake tensors
    (``FakeTensorMode``): nothing is allocated, and a collective of the fake
    group moves nothing;
  * the step is the one the reference lowers (``make_train_step`` at the
    config's micro-batching, ``make_prefill_step``, ``make_decode_step``),
    under ``sharding.set_mesh``, so the model's ``constrain`` calls act;
  * a dispatch mode beside it sees every op that runs on a local shard and
    counts what XLA's analyses gave: the FLOPs of each local matmul and
    attention op (``torch.utils.flop_counter``'s formulas: per device, not
    global), and each collective's result bytes and group size, turned into
    per-device wire bytes by the reference's ring costs
    (:func:`ring_bytes`). Ops are counted as they execute, so every loop
    trip (layers, micro-batches, KV blocks) is in the count already:
    ``"collectives_counted": "dynamic"``;
  * ``MemTracker`` follows the local tensors the step makes: its peak is
    ``temp_bytes_per_dev``, and ``peak_bytes_per_dev`` adds the arguments'
    local bytes.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all --out results/dryrun

Each cell runs on the CPU of the host (the mesh's device type is "cpu"); no
accelerator is touched. DTensor lowers a shard-to-shard move on a "cpu" mesh
to an all-gather and a chunk where NCCL would run an all-to-all: the
collective bytes are those of the collectives this run issued.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
from collections import Counter
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import CONFIGS, SHAPES, get_config
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.runtime.sharding import (ShardingRules, local_shape,
                                          placements, set_mesh)

#: the reference's collective names, by the c10d functional op that runs it
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
}


#: the range a cell's counted FLOPs per device may take around the analytic
#: model's exec FLOPs / chips (``benchmarks.flops.cell_cost``). Both count
#: the remat recompute. The count also holds the head over the padded vocab
#: (qwen3: 163,840 rows for 151,936, +7.8 % of the head) and the k/v
#: projections computed whole on each device of the model axis where the kv
#: heads do not split over it (8 on 16), which in a decode step, where they
#: are most of the matmuls beside attention, puts qwen3-1.7b's count a third
#: above; it leaves out elementwise work (AdamW, norms: a training step
#: comes out 4 % below).
FLOPS_VS_ANALYTIC = (0.9, 1.5)


def ring_bytes(kind: str, result_bytes: int, g: int) -> float:
    """Per-device wire bytes of one collective over a group of g from its
    result's bytes, the reference's ring costs:
      all-gather       (g-1)/g * result      (result = gathered buffer)
      reduce-scatter   (g-1)   * result      (result = scattered shard)
      all-reduce       2(g-1)/g * result
      all-to-all       (g-1)/g * result
      collective-permute        result"""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-reduce":
        return result_bytes * 2 * (g - 1) / g
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(kind)


def variant_rules(variant: str, kind: str) -> Optional[ShardingRules]:
    """The sharding experiments of the reference's dry-run:
      serve_replicate   inference weights replicated over (pod, data), TP
                        only over model
      serve_fsdp        FSDP'd weights for inference too
      cache_seq_data    decode KV cache sequence not sharded over model
    None (the default) lets ``cell_specs`` apply its serve-replication."""
    if variant == "serve_replicate" and kind != "train":
        return ShardingRules().with_overrides(embed=(None,))
    if variant == "serve_fsdp":
        return ShardingRules()
    if variant == "cache_seq_data":
        return ShardingRules().with_overrides(cache_seq=("data", None))
    return None


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _Recorder:
    """A dispatch mode that counts, on local shards only, the FLOPs of each
    op ``torch.utils.flop_counter`` has a formula for and the collectives
    (kind, group size, result bytes). An op on DTensors is left to DTensor
    (``NotImplemented``), which runs it as local ops and collectives that
    come back through this mode."""

    def __new__(cls):
        from torch.distributed.distributed_c10d import _resolve_process_group
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        class Recorder(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.flops = 0
                self.flops_by_op: Counter = Counter()
                self.coll_bytes: Counter = Counter()
                self.coll_counts: Counter = Counter()

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                packet = func._overloadpacket
                if packet in flop_registry:
                    n = flop_registry[packet](*args, **kwargs, out_val=out)
                    self.flops += n
                    self.flops_by_op[packet.__name__] += n
                kind = _COLLECTIVES.get(packet.__name__)
                if kind is not None and func.namespace == "_c10d_functional":
                    group = _resolve_process_group(args[-1])
                    self.coll_counts[kind] += 1
                    self.coll_bytes[kind] += ring_bytes(kind, _nbytes(out),
                                                        group.size())
                return out

        return Recorder()


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` default process group of `world_size` ranks, this process
    rank 0, for the block (none may exist before)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _dtensor_bookkeeping_apart():
    """Two pieces of DTensor's own bookkeeping are kept out of the count
    for the block:

      * sharding propagation runs each op once on fake tensors of the
        GLOBAL shapes to learn its output's shape; under the dry-run's modes
        those runs would be counted as FLOPs and as live bytes. They run
        with the modes set aside (in a fake mode of their own);
      * a strided shard's indices are computed with torch.arange and
        ``.tolist()``, which fail on fake tensors: small index tensors of
        the real computation, computed outside fake mode."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes

    meta, offsets = (ShardingPropagator._propagate_tensor_meta_non_cached,
                     _StridedShard.local_shard_size_and_offset)

    def quiet_meta(self, op_schema):
        with _disable_current_modes():
            return meta(self, op_schema)

    def real_offsets(self, *args, **kwargs):
        with unset_fake_temporarily():
            return offsets(self, *args, **kwargs)

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet_meta
    _StridedShard.local_shard_size_and_offset = real_offsets
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = meta
        _StridedShard.local_shard_size_and_offset = offsets


def _distribute(abstract, specs, mesh):
    """A tree of meta tensors + specs -> DTensors whose local shards are
    (fake) empty tensors of the shard shapes."""
    from torch.distributed.tensor import DTensor

    if isinstance(abstract, dict):
        return {k: _distribute(abstract[k], specs[k], mesh) for k in abstract}
    local = torch.empty(local_shape(abstract.shape, specs, mesh),
                        dtype=abstract.dtype)
    return DTensor.from_local(local, mesh, placements(specs, mesh),
                              run_check=False, shape=abstract.shape,
                              stride=abstract.stride())


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    leaves = (tree.values() if isinstance(tree, dict) else
              [tree] if isinstance(tree, torch.Tensor) else tree)
    total = 0
    for leaf in leaves:
        if isinstance(leaf, (dict, tuple, list)):
            total += _local_bytes(leaf)
        elif isinstance(leaf, DTensor):
            total += _nbytes(leaf.to_local())
        elif isinstance(leaf, torch.Tensor):
            total += _nbytes(leaf)
    return total


def argument_bytes_per_dev(cell: Dict[str, Any], mesh) -> int:
    """The local bytes of a cell's step inputs on one device, by arithmetic
    over ``cell_specs``' abstract leaves and specs (`mesh` may be a stub
    {axis: size} mesh): what ``argument_bytes_per_dev`` of a run must be."""
    pairs = [("params", "param_specs"), ("opt", "opt_specs"),
             ("batch", "batch_specs"), ("caches", "cache_specs")]

    def walk(abstract, specs):
        if isinstance(abstract, dict):
            return sum(walk(abstract[k], specs[k]) for k in abstract)
        return (math.prod(local_shape(abstract.shape, specs, mesh))
                * abstract.element_size())
    return sum(walk(cell[a], cell[s]) for a, s in pairs if a in cell)


def cut_depth(cfg, groups: int):
    """`cfg` with its scanned layers cut to `groups` groups of its pattern
    (the dense leading layers kept); 0 keeps the config's depth."""
    if not groups:
        return cfg
    return dataclasses.replace(
        cfg, num_layers=cfg.first_dense_layers + groups * len(cfg.pattern))


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool,
                verbose: bool = True, accum: int = 0, variant: str = "",
                moe_backend: str = "", groups: int = 0) -> Dict[str, Any]:
    """One cell's step on the fake mesh; returns its record. `variant`
    selects the sharding experiments of :func:`variant_rules`; `groups`
    cuts the depth (:func:`cut_depth`, 0: the config's)."""
    cfg = get_config(arch)
    if moe_backend:
        cfg = dataclasses.replace(cfg, moe_backend=moe_backend)
    cfg = cut_depth(cfg, groups)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    if not cfg.shape_applicable(shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "pure full-attention arch; long_500k requires "
                          "sub-quadratic attention (DESIGN.md §5)"}
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    rules = variant_rules(variant, shape.kind)
    chips = 512 if multi_pod else 256
    with fake_world(chips), _dtensor_bookkeeping_apart():
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        cell = S.cell_specs(cfg, shape, mesh, rules)
        if shape.kind == "train":
            # micro-batches so activations fit HBM, as the reference
            accum = accum or cfg.train_accum
            while shape.global_batch % accum:
                accum //= 2
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = [_distribute(cell["params"], cell["param_specs"], mesh)]
            if shape.kind == "train":
                fn = S.make_train_step(cfg, accum=accum)
                args.append(_distribute(cell["opt"], cell["opt_specs"], mesh))
                args.append(_distribute(cell["batch"], cell["batch_specs"],
                                        mesh))
            elif shape.kind == "prefill":
                fn = S.make_prefill_step(cfg, max_seq=shape.seq_len)
                args.append(_distribute(cell["batch"], cell["batch_specs"],
                                        mesh))
            else:
                fn = S.make_decode_step(cfg)
                args.append(_distribute(cell["batch"], cell["batch_specs"],
                                        mesh))
                args.append(_distribute(cell["caches"], cell["cache_specs"],
                                        mesh))
            arg_bytes = _local_bytes(args)
            mem = MemTracker()
            rec = _Recorder()
            with mem, rec, set_mesh(mesh):
                out = fn(*args)
            out_bytes = _local_bytes(out)
            snap = mem.get_tracker_snapshot("peak")
        t_run = time.time() - t0

    temp = max((d["Total"] for d in snap.values()), default=None)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "variant": variant or "default",
        "chips": chips,
        "step_kind": shape.kind,
        "accum": accum if shape.kind == "train" else None,
        "num_layers": cfg.num_layers,
        "run_s": round(t_run, 2),
        # per-device numbers (rank 0's local shards)
        "argument_bytes_per_dev": arg_bytes,
        "output_bytes_per_dev": out_bytes,
        "temp_bytes_per_dev": temp,
        "peak_bytes_per_dev": None if temp is None else temp + arg_bytes,
        "memory_counted": "MemTracker peak of the local tensors the step "
                          "made (fake), + the arguments' local bytes",
        "flops_per_dev": float(rec.flops),
        "flops_counted": "per device: torch.utils.flop_counter formulas on "
                         "rank 0's local shards (matmuls, attention)",
        "flops_by_op": dict(rec.flops_by_op),
        "collective_bytes_per_dev": int(sum(rec.coll_bytes.values())),
        "collective_kinds": {k: int(v) for k, v in rec.coll_bytes.items()},
        "collective_counts": dict(rec.coll_counts),
        "collectives_counted": "dynamic",
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"run={t_run:.1f}s "
              f"args/dev={arg_bytes / 2**30:.3f}GiB "
              f"temp/dev={(temp or 0) / 2**30:.3f}GiB "
              f"flops/dev={rec.flops:.4e} "
              f"coll/dev={result['collective_bytes_per_dev'] / 2**20:.1f}MiB")
    return result


def _tag(arch: str, shape_name: str, mesh_name: str) -> str:
    return f"{arch}__{shape_name}__{mesh_name}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch, shape) cell on both meshes")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--accum", type=int, default=0)
    ap.add_argument("--variant", default="")
    ap.add_argument("--moe-backend", default="")
    ap.add_argument("--groups", type=int, default=0,
                    help="cut the depth to this many groups of the "
                         "config's pattern (0: the config's depth)")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if not args.all:
        res = dryrun_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                          accum=args.accum, variant=args.variant,
                          moe_backend=args.moe_backend, groups=args.groups)
        print(json.dumps(res, indent=2))
        tag = _tag(res["arch"], res["shape"], res["mesh"])
        if args.variant or args.moe_backend:
            tag += f"__{args.variant or args.moe_backend}"
        (outdir / f"{tag}.json").write_text(json.dumps(res, indent=2))
        return 0
    archs = [args.arch] if args.arch else list(CONFIGS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh_name in args.meshes.split(","):
                tag = _tag(arch, shape_name, mesh_name)
                fp = outdir / f"{tag}.json"
                if fp.exists():
                    print(f"[dryrun] {tag}: cached")
                    continue
                try:
                    res = dryrun_cell(arch, shape_name,
                                      multi_pod=(mesh_name == "multi"),
                                      accum=args.accum, groups=args.groups)
                except (KeyboardInterrupt, SystemExit):
                    # never swallow an interrupt into an "error" cell: the
                    # sweep must stop, not record a bogus failure
                    raise
                except Exception as e:
                    traceback.print_exc()
                    print(f"[dryrun] {tag}: {type(e).__name__} ({e}); "
                          "recorded as an error cell, the sweep goes on",
                          file=sys.stderr)
                    res = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                fp.write_text(json.dumps(res, indent=2))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
