"""End-to-end training script of the port: a ~100M-class model for a few
hundred steps.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \
      [--arch qwen3-1.7b] [--device cuda]

Builds a ~100M-parameter variant of the chosen architecture (its layer
pattern, narrower: `small_100m`, the reference's), trains it on the
synthetic packed LM stream with the port's training step (remat, AdamW,
async checkpoints into --ckpt-dir, by default a fresh temporary directory
that is removed at the end) and prints the loss curve. Exits non-zero
unless the loss falls by more than 1.0.
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
import time

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.models.module import count_params
from repro_torch.models.transformer import model_params
from repro_torch.optim import OptimizerConfig, adamw_init


def small_100m(arch: str):
    """Full layer structure, ~100M params."""
    cfg = get_config(arch)
    pat = len(cfg.pattern)
    layers = cfg.first_dense_layers + max(1, 8 // pat) * pat
    over = dict(num_layers=layers, d_model=512, num_heads=8,
                num_kv_heads=min(cfg.num_kv_heads, 4) or 4, head_dim=64,
                d_ff=2048, vocab_size=32768, vocab_chunk=8192, train_accum=1)
    if cfg.num_kv_heads == cfg.num_heads:
        over["num_kv_heads"] = 8
    if cfg.num_experts:
        over.update(num_experts=8, experts_per_tok=2, moe_d_ff=1024)
    if cfg.ssm_heads:
        over.update(ssm_heads=8, ssm_head_dim=64, d_inner=1024,
                    ssm_state=32 if cfg.ssm_state else 0)
    if cfg.sliding_window:
        over["sliding_window"] = 256
    if cfg.shared_lora_rank:
        over["shared_lora_rank"] = 32
    if cfg.frontend_tokens:
        over["frontend_tokens"] = 16
    return dataclasses.replace(cfg, **over)


def main(argv=None):
    """Returns (first loss, last loss)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a temporary directory, removed at the end")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = small_100m(args.arch)
    print(f"[train_lm] {args.arch} variant: "
          f"{count_params(model_params(cfg))/1e6:.1f}M params, "
          f"{cfg.num_layers} layers")
    params = init_params(cfg, seed=0, device=dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, OptimizerConfig(
        lr=6e-4, warmup_steps=20, total_steps=args.steps))
    data = TokenPipeline(DataConfig(
        global_batch=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size,
        frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model,
        prefetch_distance=2), device=dev)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_lm_")
    mgr = CheckpointManager(CheckpointConfig(ckpt_dir, keep=2))
    data.start()
    t0 = time.time()
    first = None
    try:
        for step in range(args.steps):
            params, opt, m = step_fn(params, opt, next(data))
            if step == 0:
                first = float(m["loss"])
            if (step + 1) % 25 == 0:
                print(f"[train_lm] step {step+1:4d} loss "
                      f"{float(m['loss']):.4f} lr {float(m['lr']):.2e} "
                      f"({(time.time()-t0)/(step+1):.2f}s/step)")
            if (step + 1) % 100 == 0:
                mgr.save(step + 1, (params, opt))      # async unload
        mgr.wait()
    finally:
        data.stop()
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    last = float(m["loss"])
    print(f"[train_lm] loss {first:.3f} -> {last:.3f} "
          f"({args.steps} steps, {time.time()-t0:.0f}s)")
    if not last < first - 1.0:
        raise AssertionError("training did not learn")
    return first, last


if __name__ == "__main__":
    main()
