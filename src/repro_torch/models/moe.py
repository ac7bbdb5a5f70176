"""Mixture-of-Experts of the port (``repro/models/moe.py``): the top-k router
and the sort-based ``gather`` dispatch backend, with shared experts.

The gather backend argsorts the (token, k) slots by expert, builds an
(E, C) slot table, gathers the rows, runs batched per-expert GEMMs over all
E experts and combines the weighted outputs back per token. Slots ranked at
or beyond the capacity C = max(8, round_up_8(ceil(T * k / E * 1.25))) are
dropped, as in the reference. The reference's semantics are kept to the
letter: a stable argsort, drops kept out of the slot table (JAX's
``.at[].set(mode="drop")``), counts over all E, and deepseek's softmax ->
top-k routing without renormalisation. Nothing here waits on the device:
counts are a scatter-add (CUDA ``bincount`` reads its maximum back to the
host) and dropped slots write a spill column that is cut off, not a
boolean-masked subset (whose size the host would have to read).

The ``einsum`` backend (grok-1's one-hot dispatch) is not ported yet
(ROADMAP, the rest of the zoo): asking for it raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_params
from repro_torch.models.module import Param


def moe_params(cfg: ModelConfig) -> Dict[str, Any]:
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = torch.bfloat16
    p: Dict[str, Any] = {
        "router": Param((D, E), ("embed", None), torch.float32, "fan_in"),
        "w_gate": Param((E, D, Fd), ("experts", "embed", "ff"), dt, "fan_in"),
        "w_up": Param((E, D, Fd), ("experts", "embed", "ff"), dt, "fan_in"),
        "w_down": Param((E, Fd, D), ("experts", "ff", "embed"), dt, "fan_in"),
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_params(dataclasses.replace(
            cfg, d_ff=cfg.num_shared_experts * Fd))
    return p


def _counts(ids: torch.Tensor, E: int) -> torch.Tensor:
    """Occurrences of each expert id in 0..E-1 (``bincount(minlength=E)``)."""
    flat = ids.reshape(-1)
    return torch.zeros(E, dtype=torch.long, device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def _route(p, x_flat, cfg: ModelConfig):
    """Returns (ids (T, k), weights (T, k) fp32, aux_loss): deepseek's
    softmax -> top-k (grok's top-k -> softmax comes with its einsum
    backend). Top-k as ``jax.lax.top_k``: largest first, the lower expert
    first among ties."""
    k, E = cfg.experts_per_tok, cfg.num_experts
    probs = torch.softmax(x_flat.float() @ p["router"], dim=-1)
    ids = torch.argsort(probs, dim=-1, descending=True, stable=True)[:, :k]
    weights = probs.gather(-1, ids)
    # load-balance auxiliary (Switch): E * sum_e f_e * P_e
    T = x_flat.shape[0]
    f = _counts(ids, E).float() / max(T * k, 1)
    aux = E * torch.sum(f * probs.mean(dim=0))
    return ids, weights, aux


def _expert_ffn(p, h, cfg: ModelConfig):
    """h: (E, C, D) -> (E, C, D), batched per-expert gated FFN."""
    act = F.silu if cfg.mlp_type == "swiglu" else (
        lambda t: F.gelu(t, approximate="tanh"))
    g = torch.einsum("ecd,edf->ecf", h, p["w_gate"])
    u = torch.einsum("ecd,edf->ecf", h, p["w_up"])
    return torch.einsum("ecf,efd->ecd", act(g) * u, p["w_down"])


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    c = math.ceil(tokens * cfg.experts_per_tok / cfg.num_experts
                  * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _moe_gather(p, x_flat, cfg: ModelConfig):
    T, D = x_flat.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    dev = x_flat.device
    C = _capacity(cfg, T)
    ids, w, aux = _route(p, x_flat, cfg)
    flat_e = ids.reshape(-1)                                     # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts                    # exclusive
    slots = torch.arange(T * k, device=dev)
    # rank of each original slot within its expert
    rank = torch.empty_like(slots)
    rank[order] = slots - starts[sorted_e]
    valid = rank < C
    # slot table: (E, C) -> originating flat slot (token * k + kth); slots
    # ranked past the capacity land in a spill column C, cut off: dropped
    table = torch.full((E, C + 1), T * k, dtype=torch.long, device=dev)
    table[flat_e, torch.clamp(rank, max=C)] = slots
    table = table[:, :C]
    tok_of_slot = torch.clamp(table // k, max=T - 1)
    live = table < T * k
    h = torch.where(live[..., None], x_flat[tok_of_slot],
                    torch.zeros((), dtype=x_flat.dtype, device=dev))
    out = _expert_ffn(p, h, cfg)                                 # (E, C, D)
    # combine: gather each (token, kth) slot's output and weight it
    g = out[flat_e.reshape(T, k), torch.clamp(rank, max=C - 1).reshape(T, k)]
    g = torch.where(valid.reshape(T, k)[..., None], g,
                    torch.zeros((), dtype=g.dtype, device=dev))
    y = torch.einsum("tkd,tk->td", g, w.to(g.dtype))
    return y.to(x_flat.dtype), aux


def moe_apply(p, x, *, cfg: ModelConfig):
    """x: (B, S, D) -> (y, aux_loss)."""
    B, S, D = x.shape
    if cfg.moe_backend != "gather":
        raise NotImplementedError(
            f"MoE backend {cfg.moe_backend!r} is not ported yet (ROADMAP, the "
            "rest of the zoo: grok-1's einsum dispatch)")
    y, aux = _moe_gather(p, x.reshape(B * S, D), cfg)
    y = y.reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + mlp_apply(p["shared"], x, cfg=cfg)
    return y, aux
