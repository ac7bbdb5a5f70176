"""Backbone of the port (``repro/models/transformer.py``): parameter and
cache trees, prefill, the dense decode step and the paged decode step, for
dense patterns of global and sliding-window local GQA layers (("global",),
gemma2's ("local", "global"), gemma3's five local and one global), with or
without sandwich norms, for ("moe",) with GQA (grok-1) or MLA attention,
for unscanned dense leading layers (deepseek-v2's layer 0), rope or
sinusoidal positions (musicgen) and a frontend prefix in prefill
(internvl2's and musicgen's stubs).

A config's ``pattern`` forms one group; the parameter tree keeps one
subtree per pattern entry, ``"groups"/"{i}:{kind}"``, each stacked over
``num_groups``. The reference ``lax.scan``s over the groups; here the scan
is a Python loop over the same stacked tensors (group g, then entry i,
reads row g of entry i's stacked weights, a view). The unscanned dense
layers run first, from their own ``"dense"`` subtree, as in the reference.
In the single-sweep decode the loop hands each block's plane path and
layer index to the sweep kernel, which reads and updates that layer's row
of the full planes in place — a dense layer's planes have layer extent 1
and are read at layer 0. In-place update replaces the reference's XLA
input/output aliasing and buffer donation of the planes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pul import PULConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.module import stack_params


def check_supported(cfg: ModelConfig) -> None:
    """The port serves any pattern of dense global and local (sliding
    window) layers, or ("moe",) (gather or einsum dispatch), with GQA or
    MLA attention, rope or sinusoidal positions, a frontend prefix in
    prefill, sandwich norms and unscanned dense leading layers; the
    reference zoo's recurrent blocks (rwkv, mamba, zamba2's shared
    attention) and attention-free configs raise (ROADMAP, port queue)."""
    dense = set(cfg.pattern) <= {"global", "local"}
    missing = [name for name, on in (
        ("pattern other than global/local layers or ('moe',)",
         not dense and cfg.pattern != ("moe",)),
        ("attention other than GQA or MLA", cfg.attn_type not in ("gqa", "mla")),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet ({', '.join(missing)})")


def group_keys(cfg: ModelConfig):
    """Tree keys of the pattern's entries, in order ("0:local", "1:global")."""
    return [f"{i}:{kind}" for i, kind in enumerate(cfg.pattern)]


# --------------------------------------------------------------------------
# parameter and cache trees
# --------------------------------------------------------------------------
def block_params(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    p = {"norm1": L.rms_norm_params(cfg.d_model),
         "norm2": L.rms_norm_params(cfg.d_model)}
    if cfg.sandwich_norm:
        p["post_norm1"] = L.rms_norm_params(cfg.d_model)
        p["post_norm2"] = L.rms_norm_params(cfg.d_model)
    p["attn"] = (MLA.mla_params(cfg) if cfg.attn_type == "mla"
                 else L.attention_params(cfg))
    p["mlp"] = MOE.moe_params(cfg) if kind == "moe" else L.mlp_params(cfg)
    return p


def model_params(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    group = {key: block_params(cfg, kind)
             for key, kind in zip(group_keys(cfg), cfg.pattern)}
    p = {
        "embedding": L.embedding_params(cfg),
        "final_norm": L.rms_norm_params(cfg.d_model),
        "groups": stack_params(group, cfg.num_groups, "layers"),
    }
    if cfg.first_dense_layers:
        p["dense"] = {str(i): block_params(cfg, "dense")
                      for i in range(cfg.first_dense_layers)}
    return p


def local_rows(cfg: ModelConfig, max_seq: int) -> int:
    """Rows of a local layer's dense cache: a ring of min(window, max_seq)
    rows (token t at row t % rows), or max_seq under ``paged_kv``, whose
    pages map 1:1 onto token ranges (the window is then a mask term)."""
    if cfg.paged_kv:
        return max_seq
    return min(cfg.sliding_window or max_seq, max_seq)


def _block_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_seq: int):
    if cfg.attn_type == "mla":
        return MLA.mla_cache_spec(cfg, batch, max_seq)
    rows = local_rows(cfg, max_seq) if kind == "local" else max_seq
    kv = ((batch, rows, cfg.num_kv_heads, cfg.head_dim), torch.bfloat16)
    return {"k": kv, "v": kv, "idx": ((batch,), torch.int32)}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """Decode-cache tree of (shape, dtype) leaves: each pattern entry's
    leaves stacked over the groups, the dense layers' unstacked."""
    n = cfg.num_groups
    spec = {"groups": {key: {
        k: ((n, *shape), dt)
        for k, (shape, dt) in _block_cache_spec(cfg, kind, batch,
                                                max_seq).items()}
        for key, kind in zip(group_keys(cfg), cfg.pattern)}}
    if cfg.first_dense_layers:
        spec["dense"] = {str(i): _block_cache_spec(cfg, "dense", batch,
                                                   max_seq)
                         for i in range(cfg.first_dense_layers)}
    return spec


def _layer(tree: Dict[str, Any], g: int) -> Dict[str, Any]:
    """Row g of every stacked leaf (views)."""
    return {k: (_layer(v, g) if isinstance(v, dict) else v[g])
            for k, v in tree.items()}


def block_apply(p, x, *, cfg: ModelConfig, kind: str, positions,
                step_kind: str, cache=None, max_seq=None, paged=None):
    """Returns (x, new_cache)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        h, new_cache = MLA.mla_apply(p["attn"], h, cfg=cfg,
                                     positions=positions, kind=step_kind,
                                     cache=cache, max_seq=max_seq, paged=paged)
    else:
        h, new_cache = L.attention_apply(
            p["attn"], h, cfg=cfg, positions=positions, kind=step_kind,
            local=(kind == "local"), cache=cache, max_seq=max_seq,
            paged=paged)
    if cfg.sandwich_norm:
        h = L.rms_norm(h, p["post_norm1"], cfg.norm_eps)
    x = x + h
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    if kind == "moe":
        h, _ = MOE.moe_apply(p["mlp"], h, cfg=cfg)
    else:
        h = L.mlp_apply(p["mlp"], h, cfg=cfg)
    if cfg.sandwich_norm:
        h = L.rms_norm(h, p["post_norm2"], cfg.norm_eps)
    return x + h, new_cache


def _stack(caches) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _blocks(params, cfg: ModelConfig):
    """(prefix, layer index, kind, block params) of every layer in order:
    the dense layers, then group g's pattern entries for each g, the
    reference's scan order."""
    for i in range(cfg.first_dense_layers):
        yield ("dense", str(i)), 0, "dense", params["dense"][str(i)]
    entries = list(zip(group_keys(cfg), cfg.pattern))
    for g in range(cfg.num_groups):
        for key, kind in entries:
            yield ("groups", key), g, kind, _layer(params["groups"][key], g)


def _tree(cfg: ModelConfig, per_block) -> Dict[str, Any]:
    """A cache tree from one cache per block, in `_blocks` order: each
    pattern entry's caches stacked over the groups."""
    n_dense = cfg.first_dense_layers
    keys = group_keys(cfg)
    scanned = per_block[n_dense:]
    tree = {"groups": {key: _stack(scanned[i::len(keys)])
                       for i, key in enumerate(keys)}}
    if n_dense:
        tree["dense"] = {str(i): per_block[i] for i in range(n_dense)}
    return tree


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def _embed_inputs(params, tokens, cfg: ModelConfig, pos0=None,
                  frontend_embeds=None):
    """The backbone's input (reference ``_embed_inputs``): the token
    embeddings after the frontend prefix (B, Tf, D), where the config has a
    frontend and one is given, and their positions, (1, S) counting from 0
    or (B, S) counting from pos0 (B,). Sinusoidal positions are added as
    fp32 [sin | cos] cast to the activations' type. Returns (x,
    positions)."""
    x = L.embed_apply(params["embedding"], tokens, cfg=cfg)
    if cfg.frontend is not None and frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if pos0 is not None:
        positions = positions + pos0[:, None]
    if cfg.pos_embedding == "sinusoidal":
        x = x + L.sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    return x, positions


def prefill_fn(params, tokens, lengths=None, *, cfg: ModelConfig,
               max_seq: Optional[int] = None, frontend_embeds=None):
    """tokens (B, T) int; lengths (B,) real tokens per right-padded row;
    frontend_embeds (B, Tf, D), prepended to the tokens where the config
    has a frontend. Returns (logits (B, V) at each row's last real token,
    caches), the cache tree of :func:`cache_specs` at seq size max_seq
    (bf16 K/V or c_kv / k_rope, idx = Tf + T).

    The reference's quirk is kept: with a frontend prefix, `lengths` index
    the concatenated sequence (the logits are read at lengths - 1, not
    shifted by Tf)."""
    x, positions = _embed_inputs(params, tokens, cfg,
                                 frontend_embeds=frontend_embeds)
    B, T = x.shape[:2]
    caches = []
    for _, _, kind, p in _blocks(params, cfg):
        x, c = block_apply(p, x, cfg=cfg, kind=kind, positions=positions,
                           step_kind="prefill", max_seq=max_seq)
        caches.append(c)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if lengths is not None:
        last = (lengths.to(x.device).long() - 1).clamp(0, T - 1)
        xl = x[torch.arange(B, device=x.device), last][:, None, :]
    else:
        xl = x[:, -1:, :]
    logits = L.logits_apply(params["embedding"], xl, cfg=cfg)
    return logits[:, 0, :], _tree(cfg, caches)


def decode_fn(params, batch, caches, *, cfg: ModelConfig):
    """Dense decode step over per-slot caches (the assembly path and the
    dense ServingEngine).

    batch: tokens (B, 1), pos0 (B,) absolute position of the new token;
    caches: the tree of :func:`cache_specs` with each block's idx the slots'
    fill levels ((L, B) stacked for each pattern entry). Every layer writes
    the token's rows IN PLACE into `caches` at row idx % S (through views of
    the stacked leaves, so no copy of the cache is made) and attends over
    rows <= idx. Returns (logits (B, V), new caches): the same leaves, every
    idx + 1."""
    x, positions = _embed_inputs(params, batch["tokens"], cfg,
                                 pos0=batch["pos0"])
    for prefix, g, kind, p in _blocks(params, cfg):
        cache = caches[prefix[0]][prefix[1]]
        if prefix[0] == "groups":
            cache = {k: v[g] for k, v in cache.items()}
        x, _ = block_apply(p, x, cfg=cfg, kind=kind, positions=positions,
                           step_kind="decode", cache=cache)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.logits_apply(params["embedding"], x, cfg=cfg)[:, 0, :]
    new = {top: {key: {**blk, "idx": blk["idx"] + 1}
                 for key, blk in sub.items()}
           for top, sub in caches.items()}
    return logits, new


def paged_decode_fn(params, batch, caches=None, planes=None, *,
                    cfg: ModelConfig, pul_distance: int = 4):
    """Kernel-true paged decode step: attention reads KV pages directly.

    batch: tokens (B, 1), pos0 (B,) absolute position of the new token,
    lengths (B,) int32 cached tokens per slot, page_table (B, n_pages) int32
    physical frame of each slot's logical page.

    **Single sweep** (`planes` = the layout's plane dict, batch also carries
    frames/offsets (B,) int32): every layer runs the sweep kernel (K1, or K3
    for MLA) on the full planes and commits the current token's rows in
    place. Returns (logits (B, V), None).

    **Per layer** (`caches` = the layout's page-view tree, planes None):
    every layer runs K2 (K4 for MLA) over its own frames; returns (logits,
    new_caches) whose pageable leaves hold ONLY the current token's rows —
    (L, B, ...) for each pattern entry, (B, ...) for a dense layer — for the
    engine to commit (`KVPagePool.write_rows`).

    `pul_distance` is the preload distance of the in-kernel page ring (the
    engine passes the planner's d*)."""
    x, positions = _embed_inputs(params, batch["tokens"], cfg,
                                 pos0=batch["pos0"])
    pul_cfg = PULConfig(distance=pul_distance)
    lengths = batch["lengths"]
    sweep = None
    if planes is not None:
        sweep = L.PagedSweep(batch["page_table"], lengths, pul_cfg,
                             batch["frames"], batch["offsets"], planes)
    new = []
    for prefix, g, kind, p in _blocks(params, cfg):
        if sweep is not None:
            sweep.prefix, sweep.layer = prefix, g
            cache, paged = None, sweep
        else:
            leaf = caches[prefix[0]][prefix[1]]
            if prefix[0] == "groups":
                leaf = {k: v[g] for k, v in leaf.items()}
            cache = {**leaf, "idx": lengths}
            paged = (batch["page_table"], pul_cfg)
        x, nc = block_apply(p, x, cfg=cfg, kind=kind, positions=positions,
                            step_kind="paged_decode", cache=cache, paged=paged)
        new.append(nc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.logits_apply(params["embedding"], x, cfg=cfg)[:, 0, :]
    if sweep is not None:
        return logits, None
    return logits, _tree(cfg, new)
