"""Trainer of the port: data pipeline + training step + async checkpoints
+ restart, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --steps 200 --batch 8 --seq 128 --reduced --ckpt-dir CKPT

The reference's flags and printed lines. Runs on CUDA by default
(``--device cpu`` for the CPU); ``--reduced`` takes the smoke-size config.
Weights are the port's own random init from seed 0, Adam moments in bf16
where the config sets ``bf16_moments``. Restart: rerunning the same command
resumes from the latest committed checkpoint under --ckpt-dir and skips the
data stream to the restored step. ``--mesh`` (data and model parallelism
over a device mesh) is not ported yet: it raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import steps as S
from repro_torch.models import init_params
from repro_torch.optim import OptimizerConfig, adamw_init
from repro_torch.runtime.fault import HeartbeatMonitor


def main(argv=None, *, cfg=None):
    """Runs the trainer; `cfg` (a ModelConfig) replaces --arch/--reduced for
    an in-process caller. Returns {"params", "opt_state", "start", "loss"}:
    the final state, the step it resumed from, the last step's loss (None
    when no step ran)."""
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
                    help="a device mesh (e.g. 2x4): not ported; raises")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: the port trains on one device; the sharding rules and "
            "the dry-run are ported (launch.dryrun), training over a mesh "
            "(error-feedback compression, --mesh) is ROADMAP.md's next "
            "slice")

    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(1, args.steps // 20))
    train_step = S.make_train_step(cfg, opt_cfg, accum=args.accum)
    params = init_params(cfg, seed=0, device=dev)
    mdt = torch.bfloat16 if cfg.bf16_moments else torch.float32
    opt_state = adamw_init(params, mdt)
    data = TokenPipeline(DataConfig(
        global_batch=args.batch, seq_len=args.seq,
        vocab_size=cfg.vocab_size, frontend_tokens=cfg.frontend_tokens,
        d_model=cfg.d_model, prefetch_distance=2), device=dev)

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(CheckpointConfig(args.ckpt_dir))
        if mgr.latest_step() is not None:
            start, (params, opt_state) = mgr.restore(
                like=(params, opt_state), device=dev)
            print(f"[train] resumed from step {start}")
    data.skip_to(start)
    data.start()

    hb = HeartbeatMonitor()
    metrics = None
    t_last = time.time()
    try:
        for step in range(start, args.steps):
            batch = next(data)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            if (step + 1) % args.log_every == 0 or step == start:
                loss = float(metrics["loss"])
                dt = time.time() - t_last
                t_last = time.time()
                hb.beat("worker0", dt)
                print(f"[train] step {step + 1} loss {loss:.4f} "
                      f"({dt / args.log_every:.3f}s/step)")
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, (params, opt_state))   # async unload
        if mgr:
            mgr.save(args.steps, (params, opt_state), block=True)
    finally:
        data.stop()
    loss = float(metrics["loss"]) if metrics is not None else None
    print("[train] done; final loss", loss if loss is not None else "n/a")
    return {"params": params, "opt_state": opt_state, "start": start,
            "loss": loss}


if __name__ == "__main__":
    main()
