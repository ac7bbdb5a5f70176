"""Step functions of the port (``repro/launch/steps.py``): the training
step (forward, backward and AdamW, with gradient accumulation), the prefill
step and the dense decode step, each over an explicit parameter tree.

Gradients come from ``torch.autograd.grad`` over detached copies of the
parameter leaves (the same storage, marked to require grad): the caller's
tensors never require grad, so nothing of a training step leaks into a
serving engine or a captured decode step that shares them.

The sharding contracts: :func:`abstract_state` (meta tensors),
:func:`state_specs` and :func:`cell_specs` resolve every input of a step to
a spec (``runtime.sharding``) from its logical axes, so the dry-run, the
trainer and the server agree on one layout.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.models import zoo
from repro_torch.models.module import flatten, unflatten
from repro_torch.optim import OptimizerConfig, adamw_update
from repro_torch.runtime.sharding import (ShardingRules, constrain,
                                          distribute_tree, is_dtensor,
                                          mesh_shape, placements, spec_tree)


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
            k: torch.zeros_like(p) if g is None else _laid_out_as(g, p)
            for (k, p), g in zip(leaves.items(), grads)})
    return fn


def _laid_out_as(g, p):
    """A gradient in its parameter's layout, as JAX gives the cotangent of
    a sharded parameter its sharding (DTensor's backward of an unbind may
    split the stacked gradient over another dim; the update, and the next
    step's parameter, would follow it)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _micro_batches(v, accum: int):
    """The batch cut into `accum` micro-batches of contiguous rows, as the
    reference's scan takes them. A batch split over its rows (a DTensor
    under a mesh) is gathered whole and each micro-batch laid out by the
    rules for its rows ("batch"): split as the batch was where its rows
    divide that way, over fewer devices where they do not. Micro-batch i's
    rows lie on other devices than the batch's split put them, and XLA
    moves them the same way."""
    b = v.shape[0] // accum
    if not is_dtensor(v):
        return list(v.reshape(accum, b, *v.shape[1:]))
    from torch.distributed.tensor import Replicate

    whole = v.redistribute(v.device_mesh, [Replicate()] * v.device_mesh.ndim)
    rows = ("batch",) + (None,) * (v.dim() - 1)
    return [constrain(whole[i * b:(i + 1) * b], rows) for i in range(accum)]


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
            micro = {k: _micro_batches(v, accum) for k, v in batch.items()}
            g_sum = {k: torch.zeros_like(p, dtype=torch.float32)
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


# --------------------------------------------------------------------------
# sharding contracts
# --------------------------------------------------------------------------
def abstract_state(cfg: ModelConfig):
    """(params, opt_state) as meta tensors: nothing is allocated. The
    moments take bf16 where the config sets ``bf16_moments``."""
    aparams = M.abstract_tree(T.model_params(cfg))
    mdt = torch.bfloat16 if cfg.bf16_moments else torch.float32

    def moments():
        return M.map_leaves(lambda p: torch.empty(p.shape, dtype=mdt,
                                                  device="meta"), aparams)
    opt = {"m": moments(), "v": moments(),
           "step": torch.empty((), dtype=torch.int32, device="meta")}
    return aparams, opt


#: logical axes of a training batch's leaves
BATCH_LOGICAL = {"tokens": ("batch", "seq"), "targets": ("batch", "seq"),
                 "loss_mask": ("batch", "seq"),
                 "frontend_embeds": ("batch", "seq", None)}


def lay_out_state(cfg: ModelConfig, params, opt_state, mesh):
    """(params, opt_state) as DTensors on `mesh` (a DeviceMesh): the
    parameters by the sharding rules, the moments like them, the step
    replicated (every rank calls it with the same whole tensors)."""
    pl = M.param_shardings(T.model_params(cfg), mesh)
    return distribute_tree(params, pl, mesh), {
        "m": distribute_tree(opt_state["m"], pl, mesh),
        "v": distribute_tree(opt_state["v"], pl, mesh),
        "step": distribute_tree(opt_state["step"], placements((), mesh),
                                mesh)}


def state_specs(cfg: ModelConfig, mesh, rules: ShardingRules = ShardingRules()):
    """(param specs, opt-state specs): the moments are laid out as their
    parameter (ZeRO-3), the step replicated."""
    pspecs = M.param_specs(T.model_params(cfg), mesh, rules)
    return pspecs, {"m": pspecs, "v": pspecs, "step": ()}


#: bf16 weights per device after tensor parallelism below which an
#: inference cell replicates its weights over the data axes
SERVE_REPLICATE_LIMIT = 12 * 2**30


def cell_specs(cfg: ModelConfig, shape: InputShape, mesh,
               rules: Optional[ShardingRules] = None) -> Dict[str, Any]:
    """Everything a step needs for one (arch x shape) cell: abstract inputs
    and their specs, keyed by the step kind: batch, batch_specs, params,
    param_specs [, opt, opt_specs (train)] [, caches, cache_specs
    (decode)].

    Without `rules`, an inference cell replicates its weights across the
    data axes (tensor parallelism only) when count_bytes / model-axis size
    fits SERVE_REPLICATE_LIMIT: FSDP-sharded weights would be gathered
    again on every decode step. Giant models (deepseek, grok) keep FSDP."""
    if rules is None:
        rules = ShardingRules()
        if shape.kind != "train":
            tp = mesh_shape(mesh).get("model", 1)
            if M.count_bytes(T.model_params(cfg)) / tp <= SERVE_REPLICATE_LIMIT:
                rules = rules.with_overrides(embed=(None,))
    ins = zoo.input_specs(cfg, shape)
    out = {"batch": ins["batch"],
           "batch_specs": spec_tree(ins["batch_logical"], ins["batch"], mesh,
                                    rules)}
    aparams, aopt = abstract_state(cfg)
    pspecs, ospecs = state_specs(cfg, mesh, rules)
    out.update(params=aparams, param_specs=pspecs)
    if shape.kind == "train":
        out.update(opt=aopt, opt_specs=ospecs)
    if shape.kind == "decode":
        out["caches"] = ins["caches"]
        out["cache_specs"] = spec_tree(ins["caches_logical"], ins["caches"],
                                       mesh, rules)
    return out
