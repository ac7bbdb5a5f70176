"""Backbone of the port (``repro/models/transformer.py``), for the
("global",) layer pattern: parameter and cache trees, prefill and the paged
decode step.

The reference ``lax.scan``s over stacked layer weights; here the scan is a
Python loop over the same stacked tensors (layer g reads row g of each
stacked weight, a view). In the single-sweep decode the loop hands the layer
index to the sweep kernel, which reads and updates that layer's row of the
full planes in place — in-place update replaces the reference's XLA
input/output aliasing and buffer donation of the planes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pul import PULConfig
from repro_torch.models import layers as L
from repro_torch.models.module import stack_params

GROUP = "0:global"       # the one block of the ("global",) pattern


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense GQA models of the ("global",) pattern; any
    other feature of the reference zoo raises (ROADMAP, port queue)."""
    missing = [name for name, on in (
        ("pattern other than ('global',)", cfg.pattern != ("global",)),
        ("unscanned dense layers", cfg.first_dense_layers > 0),
        ("MLA attention", cfg.attn_type != "gqa"),
        ("sandwich norms", cfg.sandwich_norm),
        ("sinusoidal positions", cfg.pos_embedding != "rope"),
        ("modality frontend", cfg.frontend is not None),
        ("MoE", cfg.num_experts > 0),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet ({', '.join(missing)})")


# --------------------------------------------------------------------------
# parameter and cache trees
# --------------------------------------------------------------------------
def block_params(cfg: ModelConfig) -> Dict[str, Any]:
    return {"norm1": L.rms_norm_params(cfg.d_model),
            "norm2": L.rms_norm_params(cfg.d_model),
            "attn": L.attention_params(cfg),
            "mlp": L.mlp_params(cfg)}


def model_params(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    return {
        "embedding": L.embedding_params(cfg),
        "final_norm": L.rms_norm_params(cfg.d_model),
        "groups": stack_params({GROUP: block_params(cfg)}, cfg.num_groups,
                               "layers"),
    }


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """Decode-cache tree of (shape, dtype) leaves, stacked over layers."""
    K, hd, n = cfg.num_kv_heads, cfg.head_dim, cfg.num_groups
    kv = ((n, batch, max_seq, K, hd), torch.bfloat16)
    return {"groups": {GROUP: {"k": kv, "v": kv,
                               "idx": ((n, batch), torch.int32)}}}


def _layer(tree: Dict[str, Any], g: int) -> Dict[str, Any]:
    """Row g of every stacked leaf (views)."""
    return {k: (_layer(v, g) if isinstance(v, dict) else v[g])
            for k, v in tree.items()}


def block_apply(p, x, *, cfg: ModelConfig, positions, step_kind: str,
                cache=None, max_seq=None, paged=None):
    """Returns (x, new_cache)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    h, new_cache = L.attention_apply(p["attn"], h, cfg=cfg,
                                     positions=positions, kind=step_kind,
                                     cache=cache, max_seq=max_seq, paged=paged)
    x = x + h
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    x = x + L.mlp_apply(p["mlp"], h, cfg=cfg)
    return x, new_cache


def _stack(caches) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def prefill_fn(params, tokens, lengths=None, *, cfg: ModelConfig,
               max_seq: Optional[int] = None):
    """tokens (B, T) int; lengths (B,) real tokens per right-padded row.
    Returns (logits (B, V) at each row's last real token, caches) with
    caches["groups"]["0:global"] = {"k", "v": (L, B, max_seq, K, hd) bf16,
    "idx": (L, B) int32}."""
    B, T = tokens.shape
    x = L.embed_apply(params["embedding"], tokens, cfg=cfg)
    positions = torch.arange(T, device=x.device)[None, :]
    caches = []
    for g in range(cfg.num_groups):
        x, c = block_apply(_layer(params["groups"][GROUP], g), x, cfg=cfg,
                           positions=positions, step_kind="prefill",
                           max_seq=max_seq)
        caches.append(c)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if lengths is not None:
        last = (lengths.to(x.device).long() - 1).clamp(0, T - 1)
        xl = x[torch.arange(B, device=x.device), last][:, None, :]
    else:
        xl = x[:, -1:, :]
    logits = L.logits_apply(params["embedding"], xl, cfg=cfg)
    return logits[:, 0, :], {"groups": {GROUP: _stack(caches)}}


def paged_decode_fn(params, batch, caches=None, planes=None, *,
                    cfg: ModelConfig, pul_distance: int = 4):
    """Kernel-true paged decode step: attention reads KV pages directly.

    batch: tokens (B, 1), pos0 (B,) absolute position of the new token,
    lengths (B,) int32 cached tokens per slot, page_table (B, n_pages) int32
    physical frame of each slot's logical page.

    **Single sweep** (`planes` = the layout's plane dict, batch also carries
    frames/offsets (B,) int32): every layer runs the sweep kernel (K1) on the
    full planes and commits the current token's K/V in place. Returns
    (logits (B, V), None).

    **Per layer** (`caches` = the layout's page-view tree, planes None):
    every layer runs K2 over its own frames; returns (logits, new_caches)
    whose k/v leaves hold ONLY the current token's rows, (L, B, K, hd), for
    the engine to commit (`KVPagePool.write_rows`).

    `pul_distance` is the preload distance of the in-kernel page ring (the
    engine passes the planner's d*)."""
    x = L.embed_apply(params["embedding"], batch["tokens"], cfg=cfg)
    positions = batch["pos0"][:, None]
    pul_cfg = PULConfig(distance=pul_distance)
    lengths = batch["lengths"]
    sweep = None
    if planes is not None:
        sweep = L.PagedSweep(batch["page_table"], lengths, pul_cfg,
                             batch["frames"], batch["offsets"], planes)
        sweep.prefix = ("groups", GROUP)
    new = []
    for g in range(cfg.num_groups):
        if sweep is not None:
            sweep.layer = g
            cache, paged = None, sweep
        else:
            leaf = caches["groups"][GROUP]
            cache = {"k": leaf["k"][g], "v": leaf["v"][g], "idx": lengths}
            paged = (batch["page_table"], pul_cfg)
        x, nc = block_apply(_layer(params["groups"][GROUP], g), x, cfg=cfg,
                            positions=positions, step_kind="paged_decode",
                            cache=cache, paged=paged)
        new.append(nc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.logits_apply(params["embedding"], x, cfg=cfg)[:, 0, :]
    if sweep is not None:
        return logits, None
    return logits, {"groups": {GROUP: _stack(new)}}
