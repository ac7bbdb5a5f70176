"""Mixture-of-Experts of the port (``repro/models/moe.py``): the top-k
router and the two dispatch backends of the reference, with shared experts.

``gather`` (deepseek-v2): argsort the (token, k) slots by expert, build an
(E, C) slot table, gather the rows, run batched per-expert GEMMs over all
E experts and combine the weighted outputs back per token. The reference's
semantics are kept to the letter: a stable argsort, drops kept out of the
slot table (JAX's ``.at[].set(mode="drop")``), counts over all E, and
deepseek's softmax -> top-k routing without renormalisation. On a mesh
DTensor has no layout for the sort and the slot table's indexed writes, so
the routing integers and the rows they gather are made whole on every
device and the dispatch runs on local tensors: the capacity, the ranking
and the drops stay global, as the reference's, whatever the mesh.

``einsum`` (grok-1, the config default): capacity one-hot dispatch and
combine einsums over groups of min(T, 2048) tokens (the last group
zero-padded, its padding routed like any token), with grok's top-k over the
logits, then a softmax over the k. Each (token, k) slot's position in its
expert is a cumsum of one-hots in token order; slots at or past C drop.
The reference's rounding points are kept: the one-hots and the combine
weights are cast to the activations' type and every einsum runs in it.
The dispatch and expert products are plain GEMMs in the reference too
(outside Pallas), so ``torch.einsum`` is their port.

Both drop slots ranked at or past the capacity C = max(8,
round_up_8(ceil(T * k / E * capacity_factor))) of a group (of the whole
batch for gather). Nothing here waits on the device, so a decode step
that runs either backend can be captured: counts are a scatter-add (CUDA
``bincount`` reads its maximum back to the host), one-hots are
comparisons with an arange (``F.one_hot`` checks its indices on the
host), and dropped slots write a spill column that is cut off, not a
boolean-masked subset (whose size the host would have to read).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_params, pad_zeros
from repro_torch.models.module import Param
from repro_torch.runtime.sharding import constrain, is_dtensor, whole


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
    """Occurrences of each expert id in 0..E-1 (``bincount(minlength=E)``).
    Split over devices (a DTensor under a mesh, which has no scatter_add),
    a sum of one-hot rows: the same integers."""
    flat = ids.reshape(-1)
    if is_dtensor(flat):
        return _one_hot(flat, E, torch.long).sum(0)
    return torch.zeros(E, dtype=torch.long, device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def _route(p, x_flat, cfg: ModelConfig):
    """Returns (ids (T, k), weights (T, k) fp32, aux_loss): deepseek's
    softmax -> top-k, or grok's top-k over the logits -> softmax over the k
    (chosen by the config's name, as the reference does). Top-k as
    ``jax.lax.top_k``: largest first, the lower expert first among ties."""
    k, E = cfg.experts_per_tok, cfg.num_experts
    logits = x_flat.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    if cfg.name.startswith("grok"):
        ids = _top_k(logits, k)
        weights = torch.softmax(logits.gather(-1, ids), dim=-1)
    else:
        ids = _top_k(probs, k)
        weights = probs.gather(-1, ids)
    # load-balance auxiliary (Switch): E * sum_e f_e * P_e
    T = x_flat.shape[0]
    f = _counts(ids, E).float() / max(T * k, 1)
    aux = E * torch.sum(f * probs.mean(dim=0))
    return ids, weights, aux


def _top_k(values, k: int):
    """Indices of the k largest of each row, largest first, the lower index
    first among ties (``jax.lax.top_k``; ``torch.topk`` orders ties
    arbitrarily)."""
    return torch.argsort(values, dim=-1, descending=True, stable=True)[:, :k]


def _one_hot(idx, n: int, dtype):
    """One-hot rows of `idx` over n classes in `dtype`; an index outside
    0..n-1 gives a zero row (``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


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


def _slot_table(flat_e: torch.Tensor, T: int, k: int, E: int, C: int):
    """The gather dispatch's routing integers from the (T*k,) expert id of
    every (token, kth) slot: each slot's rank within its expert (a stable
    sort by expert, as ``jnp.argsort``) and the (E, C) slot table naming the
    flat slot (token * k + kth) that fills each place, T * k where none
    does. Slots ranked past the capacity land in a spill column C, cut off:
    dropped."""
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts                    # exclusive
    slots = torch.arange(T * k, device=dev)
    # rank of each original slot within its expert
    rank = torch.empty_like(slots)
    rank[order] = slots - starts[sorted_e]
    table = torch.full((E, C + 1), T * k, dtype=torch.long, device=dev)
    table[flat_e, torch.clamp(rank, max=C)] = slots
    return rank, table[:, :C]


def _moe_gather(p, x_flat, cfg: ModelConfig):
    T, D = x_flat.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    C = _capacity(cfg, T)
    ids, w, aux = _route(p, x_flat, cfg)
    mesh = x_flat.device_mesh if is_dtensor(x_flat) else None
    if mesh is not None:
        # DTensor has no layout for the sort, the inverse permutation or the
        # slot table's indexed writes: the routing integers (T * k and
        # E * C of them) and the rows they gather are made whole on every
        # device, and the dispatch runs on local tensors, so the global
        # capacity, the stable ranking and the drops are the reference's
        # whatever the mesh (on a 1x1 mesh the same ops on the same bits)
        from torch.distributed.tensor import DTensor, Replicate
        rep = [Replicate()] * mesh.ndim
        x_rows, ids, w = (whole(t) for t in (x_flat, ids, w))
    else:
        x_rows = x_flat
    flat_e = ids.reshape(-1)                                     # (T*k,)
    rank, table = _slot_table(flat_e, T, k, E, C)
    valid = rank < C
    tok_of_slot = torch.clamp(table // k, max=T - 1)
    live = table < T * k
    zero = torch.zeros((), dtype=x_flat.dtype, device=x_rows.device)
    h = torch.where(live[..., None], x_rows[tok_of_slot], zero)
    if mesh is not None:
        h = DTensor.from_local(h, mesh, rep, run_check=False)
    h = constrain(h, ("experts", None, None))
    out = _expert_ffn(p, h, cfg)                                 # (E, C, D)
    if mesh is not None:
        out = whole(out)
    # combine: gather each (token, kth) slot's output and weight it
    g = out[flat_e.reshape(T, k), torch.clamp(rank, max=C - 1).reshape(T, k)]
    g = torch.where(valid.reshape(T, k)[..., None], g,
                    torch.zeros((), dtype=g.dtype, device=g.device))
    y = torch.einsum("tkd,tk->td", g, w.to(g.dtype)).to(x_flat.dtype)
    if mesh is not None:
        y = DTensor.from_local(y, mesh, rep, run_check=False).redistribute(
            mesh, x_flat.placements)
    return y, aux


def _moe_einsum(p, x_flat, cfg: ModelConfig):
    T, D = x_flat.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    dt = x_flat.dtype
    Tg = min(T, 2048)
    n_groups = -(-T // Tg)
    xg = pad_zeros(x_flat, n_groups * Tg - T, dim=0).reshape(n_groups, Tg, D)
    # under a mesh each group's tokens are split over the batch axes, and
    # the groups whole on every device, so the loop takes a group locally
    xg = constrain(xg, (None, "batch", None))
    C = _capacity(cfg, Tg)
    ys, aux = [], 0.0
    for xt in xg:               # the reference's lax.scan over the groups
        ids, w, a = _route(p, xt, cfg)
        oe = _one_hot(ids, E, torch.int32)                       # (Tg, k, E)
        # position of each (token, slot) within its expert
        flat = oe.reshape(Tg * k, E)
        pos = torch.cumsum(flat, dim=0) * flat
        pos_tok = (pos.sum(dim=-1) - 1).reshape(Tg, k)
        keep = (pos_tok < C) & (pos_tok >= 0)
        oc = _one_hot(torch.where(keep, pos_tok, C), C, dt)      # (Tg, k, C)
        oe_f = oe.to(dt)
        dispatch = torch.einsum("tke,tkc->tec", oe_f, oc)        # (Tg, E, C)
        combine = torch.einsum("tke,tkc,tk->tec", oe_f, oc, w.to(dt))
        h = torch.einsum("td,tec->ecd", xt, dispatch)
        h = constrain(h, ("experts", None, None))
        out = _expert_ffn(p, h, cfg)
        ys.append(torch.einsum("ecd,tec->td", out, combine))
        aux = aux + a
    y = torch.cat(ys)[:T]
    return y, aux / n_groups


def moe_apply(p, x, *, cfg: ModelConfig):
    """x: (B, S, D) -> (y, aux_loss), dispatched on cfg.moe_backend."""
    B, S, D = x.shape
    x_flat = x.reshape(B * S, D)
    if cfg.moe_backend == "einsum":
        y, aux = _moe_einsum(p, x_flat, cfg)
    elif cfg.moe_backend == "gather":
        y, aux = _moe_gather(p, x_flat, cfg)
    else:
        raise ValueError(f"unknown moe backend {cfg.moe_backend}")
    y = y.reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + mlp_apply(p["shared"], x, cfg=cfg)
    return y, aux
