"""Step functions of the port (``repro/launch/steps.py``): the training
step (forward, backward and AdamW, with gradient accumulation), the prefill
step and the dense decode step, each over an explicit parameter tree.

Gradients come from ``torch.autograd.grad`` over detached copies of the
parameter leaves (the same storage, marked to require grad): the caller's
tensors never require grad, so nothing of a training step leaks into a
serving engine or a captured decode step that shares them. The reference's
sharding contracts (``abstract_state``, ``state_specs``, ``cell_specs``)
need a mesh and are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.module import flatten, unflatten
from repro_torch.optim import OptimizerConfig, adamw_update


def value_and_grad(cfg: ModelConfig):
    """(params, batch) -> (loss, grads): the training loss and its
    gradient, one tensor per parameter in the parameter's type (zeros for
    a parameter the loss does not reach, as JAX returns)."""
    def fn(params, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flatten(params)}
        with torch.enable_grad():
            loss = T.loss_fn(unflatten(leaves), batch, cfg=cfg)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        return loss.detach(), unflatten({
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(leaves.items(), grads)})
    return fn


def make_train_step(cfg: ModelConfig,
                    opt_cfg: OptimizerConfig = OptimizerConfig(),
                    accum: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics): forward,
    backward and one AdamW update. With `accum` > 1 the batch is cut into
    `accum` micro-batches along its first axis; their gradients are summed
    in fp32 from fp32 zeros and the loss and the sum divided by `accum`, as
    the reference's scan does. With accum 1 the gradients keep the
    parameters' type (which changes the global norm's inputs, as in the
    reference). metrics: loss, grad_norm, lr, step."""
    grads_of = value_and_grad(cfg)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = grads_of(params, batch)
        else:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            g_sum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in flatten(params)}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(g_sum.values())).device)
            for i in range(accum):
                l, g = grads_of(params, {k: v[i] for k, v in micro.items()})
                for k, gk in flatten(g):
                    g_sum[k].add_(gk)
                loss = loss + l
                del g
            loss = loss / accum
            grads = unflatten({k: g.div_(accum) for k, g in g_sum.items()})
        new_params, new_opt, metrics = adamw_update(grads, opt_state, params,
                                                    opt_cfg)
        return new_params, new_opt, dict(metrics, loss=loss)

    return train_step


def make_prefill_step(cfg: ModelConfig, max_seq: Optional[int] = None):
    """(params, batch) -> (last-token logits (B, V), caches); batch: tokens
    [, lengths, frontend_embeds] (see transformer.prefill_fn)."""
    def prefill_step(params, batch: Dict[str, Any]):
        with torch.no_grad():
            return T.prefill_fn(params, batch["tokens"], batch.get("lengths"),
                                cfg=cfg, max_seq=max_seq,
                                frontend_embeds=batch.get("frontend_embeds"))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, batch, caches) -> (logits (B, V), caches): one dense decode
    step (see transformer.decode_fn)."""
    def decode_step(params, batch, caches):
        with torch.no_grad():
            return T.decode_fn(params, batch, caches, cfg=cfg)
    return decode_step
