"""AdamW with global-norm clipping and a cosine schedule (port of
``repro/optim/optimizer.py``).

A functional update over the parameter tree (nested dicts of tensors, as
``models.module.init_tree`` builds), not ``torch.optim.AdamW``: it returns
new parameters and a new state and keeps the reference's cast points. The
math runs in fp32; the moments are stored in their own type (fp32, or
bf16 for the giant configs' ``bf16_moments``) and the new parameter is cast
back to the parameter's type. The global norm sums every gradient's squares
in fp32, leaf by leaf in the tree's sorted-path order, and the clip scale
is min(1, clip_norm / (norm + 1e-9)). Decoupled weight decay skips tensors
of one dimension or fewer, by ``p.ndim`` as the reference does: a group's
norm scales are stacked over the groups, so they are 2-D and decayed, while
the unstacked dense layers' norms and ``final_norm`` are not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.module import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup to cfg.lr, then a cosine down to min_lr_ratio * lr over
    total_steps, in fp32 (step: an int or an integer tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(params, moment_dtype=torch.float32) -> Dict[str, Any]:
    """Zero moments shaped like `params` in `moment_dtype`, and step 0."""
    zeros = {path: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
             for path, p in flatten(params)}
    device = next(iter(zeros.values())).device
    return {"m": unflatten(zeros),
            "v": unflatten({k: torch.zeros_like(z) for k, z in zeros.items()}),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares in fp32."""
    sq = sum(torch.sum(torch.square(g.float())) for _, g in flatten(tree))
    return torch.sqrt(sq)


def adamw_update(grads, state, params, cfg: OptimizerConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (new params, new state, metrics {grad_norm,
    lr, step}); nothing given is modified."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=stepf.device), stepf)

    def upd(g, m, v, p):
        mdt = m.dtype
        g = g.float() * scale
        m = b1 * m.float() + (1 - b1) * g
        v = b2 * v.float() + (1 - b2) * torch.square(g)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        # decoupled weight decay (skips 1-d tensors: unstacked norms/biases)
        if p.dim() > 1:
            delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, m.to(mdt), v.to(mdt)

    flat_m, flat_v = dict(flatten(state["m"])), dict(flatten(state["v"]))
    flat_p = dict(flatten(params))
    out = {path: upd(g, flat_m[path], flat_v[path], flat_p[path])
           for path, g in flatten(grads)}
    new_p = unflatten({k: o[0] for k, o in out.items()})
    new_m = unflatten({k: o[1] for k, o in out.items()})
    new_v = unflatten({k: o[2] for k, o in out.items()})
    metrics = {"grad_norm": gnorm, "lr": lr, "step": step}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
