"""A mesh computes what no mesh computes.

  PYTHONPATH=src python -m repro_torch.launch.mesh_parity [--device cuda] \
      [--reduced] [--arch qwen3-1.7b] [--prompt 2304] [--mesh 1x1]

The sharded path (parameters, batch and caches as DTensors laid out by the
port's sharding rules, the model's ``constrain`` calls acting under
``sharding.set_mesh``) runs on a ("data", "model") mesh, each step twice
from the same inputs: without a mesh and on it.

  * ``make_prefill_step`` of the config (full width unless --reduced) on a
    (batch, prompt) token block: logits and every cache leaf;
  * ``make_decode_step`` one token on from the no-mesh prefill's caches:
    logits and caches;
  * one ``make_train_step`` of ``examples.train_lm.small_100m`` (of the
    reduced config with --reduced) at two micro-batches whose loss masks
    count different tokens: every leaf of the new parameters and optimizer
    state, the loss and the gradient norm.

``--mesh 1x1`` (the default) runs on a one-rank process group (``nccl`` on
CUDA, ``gloo`` on the CPU) and holds the mesh to the same bits: no mesh
route is taken there, every op is the unmeshed one. A larger mesh
(``--mesh 2x2``, ``1x4``; the CPU only) spawns one ``gloo`` process per
rank and runs fp32 parameters, so that the routes that split a dim act
(the matmul projection, the repeated kv heads, the vocab-split lookup and
cross-entropy, the sequence-split decode cache, the micro-batches gathered
and split again) and are held at :data:`TOLERANCE`: their sums over split
dims round in another order than the unmeshed ones (the training step
there takes AdamW's eps at :data:`WIDE_MESH_EPS`). Every group meets
through a ``FileStore`` in a temporary directory: no network.

It prints one JSON object: for each step, how many elements differ in
their bits (1x1; each must be 0) or its worst error over the limit (each
must be at most 1), and exits non-zero when any step fails.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_debug_mesh, one_rank_mesh
from repro_torch.models import demo_batch, init_params
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.optim import OptimizerConfig, adamw_init
from repro_torch.runtime.sharding import (distribute_tree, set_mesh,
                                          sharding_tree, whole)

_INT_OF = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

#: |mesh - no mesh| over max|no mesh| allowed for a leaf on a mesh wider
#: than 1x1, by dtype. fp32: sums split over devices round in another order,
#: and a training step carries that through the forward, the backward and
#: AdamW: at reduced width the logits differ by about 1e-6, the train step
#: of a transformer by under 7e-6, rwkv6's (its scan sums exponentials of
#: cumulative decays) by up to 1.7e-5; micro-batches of the wrong rows or
#: kv heads repeated in the wrong order moved them by 1e-3 to 1. bf16 (the caches): one unit in the last place at the
#: leaf's largest magnitude, since a value near a rounding boundary may
#: round either way. Integers and bools are held exactly.
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def bit_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """How many elements of a and b differ in their bits (all of them when
    shapes or types differ); a DTensor is compared whole."""
    a, b = whole(a), whole(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel())
    if a.dtype == torch.bool:
        return int((a != b).sum())
    it = _INT_OF[a.element_size()]
    return int((a.contiguous().view(it) != b.contiguous().view(it)).sum())


def tol_err(want: torch.Tensor, got: torch.Tensor) -> float:
    """max|got - want| / (TOLERANCE[dtype] * max|want|), a DTensor compared
    whole: at most 1 when `got` holds. inf when shapes or types differ, a
    value is not finite, or an integer or bool element differs."""
    want, got = whole(want), whole(got)
    if want.shape != got.shape or want.dtype != got.dtype:
        return math.inf
    if not want.is_floating_point():
        return math.inf if bool((want != got).any()) else 0.0
    if not want.numel():
        return 0.0
    if not bool(torch.isfinite(got).all()):
        return math.inf
    w, g = want.double(), got.double()
    scale = TOLERANCE[want.dtype] * max(float(w.abs().max()), 1e-30)
    return float((g - w).abs().max()) / scale


def tree_diff(a, b, leaf=bit_diff):
    """`leaf` over two trees of one structure: the bit counts summed, or
    the largest error over its limit."""
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            raise ValueError(f"trees differ: {sorted(a)} vs {sorted(b)}")
        vals = [tree_diff(a[k], b[k], leaf) for k in a]
    elif isinstance(a, (tuple, list)):
        vals = [tree_diff(x, y, leaf) for x, y in zip(a, b, strict=True)]
    else:
        return leaf(a, b)
    return sum(vals) if leaf is bit_diff else max(vals, default=0.0)


def _clone(tree, f32: bool = False):
    """A copy of `tree`; with `f32` its floating leaves in fp32 (the decode
    of fp32 weights reads fp32 caches)."""
    return {k: _clone(v, f32) if isinstance(v, dict)
            else v.float() if f32 and v.is_floating_point() else v.clone()
            for k, v in tree.items()}


def _params_on(cfg, params, mesh):
    return distribute_tree(params, M.param_shardings(T.model_params(cfg),
                                                     mesh), mesh)


def _batch_on(batch, logical, mesh):
    return distribute_tree(batch, sharding_tree(logical, batch, mesh), mesh)


def _init(cfg, device, f32: bool):
    params = init_params(cfg, seed=0, device=device)
    if f32:
        params = M.unflatten({k: v.float() for k, v in M.flatten(params)})
    return params


def serve_parity(cfg, mesh, *, batch: int, prompt: int, device,
                 leaf=bit_diff, f32: bool = False) -> Dict:
    """Prefill and one decode step of `cfg`, without and with the mesh."""
    params = _init(cfg, device, f32)
    gen = torch.Generator(device="cpu").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                           dtype=torch.int32).to(device)
    max_seq = 2 * prompt
    prefill = S.make_prefill_step(cfg, max_seq=max_seq)
    decode = S.make_decode_step(cfg)
    logits, caches = prefill(params, {"tokens": tokens})
    dparams = _params_on(cfg, params, mesh)
    with set_mesh(mesh):
        dlogits, dcaches = prefill(dparams, _batch_on(
            {"tokens": tokens}, {"tokens": ("batch", "seq")}, mesh))
    out = {"prefill_logits": leaf(logits, dlogits),
           "prefill_caches": tree_diff(caches, dcaches, leaf)}
    step = {"tokens": logits.argmax(-1).to(torch.int32)[:, None],
            "pos0": torch.full((batch,), prompt, dtype=torch.int32,
                               device=device)}
    logical = T.cache_logical(cfg)
    mesh_caches = _batch_on(_clone(caches, f32), logical, mesh)
    logits2, caches2 = decode(params, step, _clone(caches, f32))
    with set_mesh(mesh):
        dlogits2, dcaches2 = decode(dparams, _batch_on(
            step, {"tokens": ("batch", None), "pos0": ("batch",)}, mesh),
            mesh_caches)
    out.update(decode_logits=leaf(logits2, dlogits2),
               decode_caches=tree_diff(caches2, dcaches2, leaf))
    return out


def uneven_loss_mask(batch: int, seq: int, device) -> torch.Tensor:
    """A (batch, seq) loss mask whose row r counts seq - 3r tokens (at
    least one): micro-batches of contiguous rows count different tokens,
    so the micro-batch means depend on which rows go together."""
    n = (seq - 3 * torch.arange(batch)).clamp(min=1)
    return (torch.arange(seq)[None, :] < n[:, None]).float().to(device)


#: AdamW's eps on a mesh wider than 1x1. The default 1e-8 maps a gradient
#: element g to about lr * g / (|g| + 1e-8): where |g| is near 1e-8 (the
#: zero-initialised norm weights have such elements) a reduction-order
#: difference of a few 1e-7 of the leaf's largest gradient moves the update
#: by up to lr, and the new parameters cannot be held at fp32 tolerance.
#: At 1e-3 the update is about lr * g / 1e-3 there and keeps g's accuracy;
#: the gradients themselves are held through the moments either way.
WIDE_MESH_EPS = 1e-3


def train_parity(cfg, mesh, *, batch: int, seq: int, accum: int, device,
                 leaf=bit_diff, f32: bool = False,
                 opt_cfg: OptimizerConfig = OptimizerConfig()) -> Dict:
    """One training step of `cfg` at `accum` micro-batches, without and
    with the mesh."""
    params = _init(cfg, device, f32)
    opt = adamw_init(params)
    data = demo_batch(cfg, batch, seq, seed=0, device=device)
    data["loss_mask"] = uneven_loss_mask(batch, seq, device)
    step = S.make_train_step(cfg, opt_cfg, accum=accum)
    new_p, new_o, metrics = step(params, opt, data)
    dparams, dopt = S.lay_out_state(cfg, params, opt, mesh)
    with set_mesh(mesh):
        dp, do, dm = step(dparams, dopt, _batch_on(
            data, {k: S.BATCH_LOGICAL[k] for k in data}, mesh))
    return {"train_params": tree_diff(new_p, dp, leaf),
            "train_opt": tree_diff(new_o, do, leaf),
            "train_metrics": tree_diff(metrics, dm, leaf)}


def _both(cfg, train_cfg, mesh, *, dev, batch, prompt, train_batch,
          train_seq, accum, wide: bool) -> Dict[str, Any]:
    """Serve and train parity: bitwise on a 1x1 mesh; at TOLERANCE with
    fp32 weights (and WIDE_MESH_EPS) on a `wide` one."""
    leaf = tol_err if wide else bit_diff
    out = serve_parity(cfg, mesh, batch=batch, prompt=prompt, device=dev,
                       leaf=leaf, f32=wide)
    out.update(train_parity(
        train_cfg, mesh, batch=train_batch, seq=train_seq, accum=accum,
        device=dev, leaf=leaf, f32=wide, opt_cfg=OptimizerConfig(
            eps=WIDE_MESH_EPS) if wide else OptimizerConfig()))
    return out


def _rank_main(rank: int, world: int, store: str, shape: Tuple[int, int],
               result: str, cfg, train_cfg, kw) -> None:
    """One rank of a CPU mesh wider than 1x1 (``torch.multiprocessing``
    spawns it); rank 0 writes the result to `result`."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh(*shape, device_type="cpu")
        out = _both(cfg, train_cfg, mesh, dev=torch.device("cpu"),
                    wide=True, **kw)
        if rank == 0:
            with open(result, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def run(cfg, train_cfg, *, device="cuda", mesh=(1, 1), batch: int = 2,
        prompt: int = 2304, train_batch: int = 4, train_seq: int = 256,
        accum: int = 2) -> Dict[str, Any]:
    """Both parities on a (data, model) = `mesh` mesh: bits differing on a
    one-rank 1x1 mesh of `device`'s type; the worst error over its limit on
    a wider CPU mesh, one spawned gloo process per rank."""
    kw = dict(batch=batch, prompt=prompt, train_batch=train_batch,
              train_seq=train_seq, accum=accum)
    dev = resolve_device(device)
    if tuple(mesh) == (1, 1):
        with one_rank_mesh(dev.type) as m:
            return _both(cfg, train_cfg, m, dev=dev, wide=False, **kw)
    if dev.type != "cpu":
        raise ValueError(f"a {mesh[0]}x{mesh[1]} mesh runs on the CPU only")
    import torch.multiprocessing as mp

    from repro_torch.launch import mesh_parity
    world = math.prod(mesh)
    with tempfile.TemporaryDirectory() as d:
        result = os.path.join(d, "result.json")
        mp.spawn(mesh_parity._rank_main, nprocs=world, join=True, args=(
            world, os.path.join(d, "store"), tuple(mesh), result, cfg,
            train_cfg, kw))
        with open(result) as f:
            return json.load(f)


def main(argv=None) -> int:
    from repro_torch.examples.train_lm import small_100m

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prompt", type=int, default=2304,
                    help="prompt tokens (above 2048 the prefill streams "
                         "its attention over KV blocks)")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL; wider than 1x1 on the CPU only")
    args = ap.parse_args(argv)
    mesh = tuple(int(n) for n in args.mesh.split("x"))
    cfg = get_config(args.arch)
    train_cfg = small_100m(args.arch)
    if args.reduced:
        cfg, train_cfg = cfg.reduced(), cfg.reduced()
    diffs = run(cfg, train_cfg, device=args.device, mesh=mesh,
                prompt=args.prompt)
    bitwise = mesh == (1, 1)
    print(json.dumps({"arch": args.arch, "reduced": args.reduced,
                      "mesh": args.mesh, "num_layers": cfg.num_layers,
                      "differing" if bitwise else "err_over_limit": diffs}))
    if bitwise:
        return 1 if any(diffs.values()) else 0
    return 0 if all(v <= 1.0 for v in diffs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
