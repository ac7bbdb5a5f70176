"""Trainer of the port: data pipeline + training step + async checkpoints
+ restart, on one device or over a (data, model) mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --steps 200 --batch 8 --seq 128 --reduced --ckpt-dir CKPT
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train ... --mesh 2x2

The reference's flags and printed lines. Runs on CUDA by default
(``--device cpu`` for the CPU); ``--reduced`` takes the smoke-size config.
Weights are the port's own random init from seed 0, Adam moments in bf16
where the config sets ``bf16_moments``. Restart: rerunning the same command
resumes from the latest committed checkpoint under --ckpt-dir and skips the
data stream to the restored step.

``--mesh DxM`` trains over a ("data", "model") mesh of D * M ranks: the
process group a spawner opened already, one that ``torchrun`` describes in
the environment (nccl on CUDA, gloo on the CPU; each rank on the card of
its ``LOCAL_RANK``), or, for ``1x1`` in a lone process, a one-rank group
(``launch.mesh.one_rank_mesh``). Each rank inits the parameters from seed 0
as the one-device trainer does and lays them out by the sharding rules
(FSDP over data, tensor parallelism over model), the AdamW moments like the
parameters and the step replicated; it reads the same global batch from its
own pipeline and lays it out by the batch rule, and runs the step under
``sharding.set_mesh``. Checkpoints are the one-device format (rank 0
writes; every rank restores and lays the leaves out again), so a run may
resume on another mesh or on one device. Only rank 0 prints. Without
``--mesh`` the port trains on one device; the reference trains over a
(device_count, 1) mesh there.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_debug_mesh, one_rank_mesh
from repro_torch.models import init_params
from repro_torch.models import module as M
from repro_torch.optim import OptimizerConfig, adamw_init
from repro_torch.runtime.fault import HeartbeatMonitor
from repro_torch.runtime.sharding import (distribute_tree, set_mesh,
                                          sharding_tree, whole)

def parse_mesh(text: str):
    """"DxM" -> (D, M)."""
    try:
        d, m = (int(n) for n in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DATAxMODEL, e.g. 2x2"
                         ) from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {text!r}: both sizes must be at least 1")
    return d, m


@contextlib.contextmanager
def mesh_group(shape, device_type: str):
    """Yields (mesh, owned): the (data, model) mesh of `shape` on the open
    default process group, on one that torchrun describes (WORLD_SIZE in
    the environment), or on a one-rank group for (1, 1); `owned` when this
    call opened the group (and closes it after the block). Raises unless
    the group has D * M ranks."""
    import torch.distributed as dist

    n = shape[0] * shape[1]
    what = f"--mesh {shape[0]}x{shape[1]} needs {n} rank(s)"
    owned = False
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(
                "nccl" if device_type == "cuda" else "gloo")
            owned = True
        elif n == 1:
            with one_rank_mesh(device_type) as mesh:
                yield mesh, True
            return
        else:
            raise ValueError(f"{what}, and this process belongs to no "
                             "process group: launch it with torchrun "
                             f"--nproc-per-node {n}, or from a spawner that "
                             "opens the group")
    try:
        world = dist.get_world_size()
        if world != n:
            raise ValueError(f"{what}; the process group has {world}")
        yield make_debug_mesh(*shape, device_type=device_type), owned
    finally:
        if owned:
            dist.destroy_process_group()


def _rank_device(dev: torch.device) -> torch.device:
    """A rank's card: its LOCAL_RANK's (torchrun), else the given one."""
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    return dev


def main(argv=None, *, cfg=None):
    """Runs the trainer; `cfg` (a ModelConfig) replaces --arch/--reduced for
    an in-process caller. Returns {"params", "opt_state", "start", "loss",
    "losses", "step_s"}: the final state, the step it resumed from, the
    last step's loss (None when no step ran), every step's loss, and the
    seconds a step of each logged interval (the printed figure, unrounded;
    the loss read at a log step waits for the device). On a mesh the state
    is DTensors, or whole tensors where the trainer opened the process
    group itself (it is closed when this returns)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=cfg is None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x4 => (data=2, model=4) over 8 ranks")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    if not args.mesh:
        return _train(args, cfg, dev, None)
    with mesh_group(parse_mesh(args.mesh), dev.type) as (mesh, owned):
        out = _train(args, cfg, _rank_device(dev), mesh)
        if owned:
            for key in ("params", "opt_state"):
                out[key] = M.map_leaves(whole, out[key])
        return out


def _train(args, cfg, dev, mesh):
    import torch.distributed as dist

    rank = dist.get_rank() if mesh is not None else 0
    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(1, args.steps // 20))
    train_step = S.make_train_step(cfg, opt_cfg, accum=args.accum)
    params = init_params(cfg, seed=0, device=dev)
    mdt = torch.bfloat16 if cfg.bf16_moments else torch.float32
    opt_state = adamw_init(params, mdt)
    if mesh is not None:
        params, opt_state = S.lay_out_state(cfg, params, opt_state, mesh)
    data = TokenPipeline(DataConfig(
        global_batch=args.batch, seq_len=args.seq,
        vocab_size=cfg.vocab_size, frontend_tokens=cfg.frontend_tokens,
        d_model=cfg.d_model, prefetch_distance=2), device=dev)

    def say(*a):
        if rank == 0:
            print(*a)

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(CheckpointConfig(args.ckpt_dir))
        if mesh is not None:
            dist.barrier()              # every rank reads the same files
        if mgr.latest_step() is not None:
            start, (params, opt_state) = mgr.restore(
                like=(params, opt_state), device=dev)
            say(f"[train] resumed from step {start}")
    data.skip_to(start)
    data.start()

    hb = HeartbeatMonitor()
    losses, step_s = [], []
    t_last = time.time()
    try:
        for step in range(start, args.steps):
            batch = next(data)
            if mesh is not None:
                batch = distribute_tree(batch, sharding_tree(
                    {k: S.BATCH_LOGICAL[k] for k in batch}, batch, mesh), mesh)
            with set_mesh(mesh):
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
            losses.append(metrics["loss"])
            if (step + 1) % args.log_every == 0 or step == start:
                loss = float(whole(metrics["loss"]))
                dt = time.time() - t_last
                t_last = time.time()
                step_s.append(dt / args.log_every)
                hb.beat(f"worker{rank}", dt)
                say(f"[train] step {step + 1} loss {loss:.4f} "
                    f"({dt / args.log_every:.3f}s/step)")
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, (params, opt_state))   # async unload
        if mgr:
            mgr.save(args.steps, (params, opt_state), block=True)
    finally:
        data.stop()
    losses = [float(whole(x)) for x in losses]
    loss = losses[-1] if losses else None
    say("[train] done; final loss", loss if loss is not None else "n/a")
    return {"params": params, "opt_state": opt_state, "start": start,
            "loss": loss, "losses": losses, "step_s": step_s}


if __name__ == "__main__":
    main()
