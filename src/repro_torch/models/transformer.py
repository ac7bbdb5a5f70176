"""Backbone of the port (``repro/models/transformer.py``): parameter and
cache trees, the training loss (with one remat checkpoint per group),
prefill, the dense decode step and the paged decode step, for
every pattern of the reference zoo: global and sliding-window local GQA
layers (("global",), gemma2's ("local", "global"), gemma3's five local and
one global), with or without sandwich norms; ("moe",) with GQA (grok-1) or
MLA attention; unscanned dense leading layers (deepseek-v2's layer 0); the
recurrent blocks, RWKV6's ("rwkv",) and zamba2's ("mamba", "mamba",
"shared_attn"), whose shared attention block is applied at every
invocation with that invocation's LoRA delta merged into its q/k/v
weights; rope or sinusoidal positions (musicgen) and a frontend prefix in
prefill (internvl2's and musicgen's stubs).

A config's ``pattern`` forms one group; the parameter tree keeps one
subtree per pattern entry, ``"groups"/"{i}:{kind}"``, each stacked over
``num_groups``, and zamba2's shared block once, under ``"shared"``. The
reference ``lax.scan``s over the groups; here the scan is a Python loop
over the same stacked tensors (group g, then entry i, reads row g of entry
i's stacked weights, a view). The unscanned dense layers run first, from
their own ``"dense"`` subtree, as in the reference. In the single-sweep
decode the loop hands each attention block's plane path and layer index to
the sweep kernel, which reads and updates that layer's row of the full
planes in place — a dense layer's planes have layer extent 1 and are read
at layer 0. In-place update replaces the reference's XLA input/output
aliasing and buffer donation of the planes.

A recurrent block's state (RWKV's S and token-shift carries, Mamba's h and
conv state) is not pageable: prefill returns it beside the KV caches, and a
decode step (dense or paged) takes it in the cache tree and returns its
successor, as new tensors; a paged decode step is an ordinary decode step
for these blocks, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pul import PULConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.module import Param, stack_params
from repro_torch.runtime.sharding import constrain

#: the reference's block kinds
BLOCK_KINDS = ("global", "local", "moe", "dense", "rwkv", "mamba",
               "shared_attn")
#: kinds whose cache is recurrent state, not pageable KV
RECURRENT_KINDS = ("rwkv", "mamba")


def check_supported(cfg: ModelConfig) -> None:
    """Raises for what the reference itself lacks: a pattern kind outside
    BLOCK_KINDS, an attention type other than GQA, MLA or none."""
    missing = [name for name, on in (
        (f"pattern kinds {sorted(set(cfg.pattern) - set(BLOCK_KINDS))}",
         not set(cfg.pattern) <= set(BLOCK_KINDS)),
        (f"attention type {cfg.attn_type!r}",
         cfg.attn_type not in ("gqa", "mla", "none")),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the reference has no {', '.join(missing)}")


def group_keys(cfg: ModelConfig):
    """Tree keys of the pattern's entries, in order ("0:local", "1:global")."""
    return [f"{i}:{kind}" for i, kind in enumerate(cfg.pattern)]


# --------------------------------------------------------------------------
# parameter and cache trees
# --------------------------------------------------------------------------
def _attn_mlp_block_params(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    p = {"norm1": L.rms_norm_params(cfg.d_model),
         "norm2": L.rms_norm_params(cfg.d_model)}
    if cfg.sandwich_norm:
        p["post_norm1"] = L.rms_norm_params(cfg.d_model)
        p["post_norm2"] = L.rms_norm_params(cfg.d_model)
    p["attn"] = (MLA.mla_params(cfg) if cfg.attn_type == "mla"
                 else L.attention_params(cfg))
    p["mlp"] = MOE.moe_params(cfg) if kind == "moe" else L.mlp_params(cfg)
    return p


def _lora_params(cfg: ModelConfig) -> Dict[str, Any]:
    """Zamba2's per-invocation LoRA of the shared q/k/v projections; the B
    matrices start at zero, as in the reference."""
    D, H, hd, r = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.shared_lora_rank
    K = cfg.num_kv_heads
    dt = torch.bfloat16
    return {
        "q_a": Param((D, r), ("embed", "lora"), dt, "fan_in"),
        "q_b": Param((r, H * hd), ("lora", "dinner"), dt, "zeros"),
        "k_a": Param((D, r), ("embed", "lora"), dt, "fan_in"),
        "k_b": Param((r, K * hd), ("lora", "dinner"), dt, "zeros"),
        "v_a": Param((D, r), ("embed", "lora"), dt, "fan_in"),
        "v_b": Param((r, K * hd), ("lora", "dinner"), dt, "zeros"),
    }


def block_params(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    if kind == "rwkv":
        return SSM.rwkv_params(cfg)
    if kind == "mamba":
        return SSM.mamba_params(cfg)
    if kind == "shared_attn":
        return _lora_params(cfg) if cfg.shared_lora_rank else {}
    return _attn_mlp_block_params(cfg, kind)


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
    if "shared_attn" in cfg.pattern:
        p["shared"] = _attn_mlp_block_params(cfg, "global")
    return p


def local_rows(cfg: ModelConfig, max_seq: int) -> int:
    """Rows of a local layer's dense cache: a ring of min(window, max_seq)
    rows (token t at row t % rows), or max_seq under ``paged_kv``, whose
    pages map 1:1 onto token ranges (the window is then a mask term)."""
    if cfg.paged_kv:
        return max_seq
    return min(cfg.sliding_window or max_seq, max_seq)


def _block_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_seq: int):
    if kind == "rwkv":
        return SSM.rwkv_state_spec(cfg, batch)
    if kind == "mamba":
        return SSM.mamba_state_spec(cfg, batch)
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


def _block_cache_logical(cfg: ModelConfig, kind: str):
    if kind == "rwkv":
        return SSM.rwkv_state_logical()
    if kind == "mamba":
        return SSM.mamba_state_logical()
    if cfg.attn_type == "mla":
        return MLA.mla_cache_logical()
    return L.attention_cache_logical()


def cache_logical(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of every leaf of :func:`cache_specs`' tree (the
    reference's ``cache_specs`` returns them beside the shapes): a stacked
    entry's leaves lead with an unsharded layer axis."""
    out = {"groups": {key: {k: (None, *lg) for k, lg in
                            _block_cache_logical(cfg, kind).items()}
                      for key, kind in zip(group_keys(cfg), cfg.pattern)}}
    if cfg.first_dense_layers:
        out["dense"] = {str(i): _block_cache_logical(cfg, "dense")
                        for i in range(cfg.first_dense_layers)}
    return out


def _group_end(x, cfg: ModelConfig, prefix):
    """The reference's constraint on the scan carry after each group's
    last entry (identity outside a mesh)."""
    if prefix[0] == "groups" and prefix[1] == group_keys(cfg)[-1]:
        return constrain(x, ("batch", None, None))
    return x


def _unbind(tree: Dict[str, Any], n: int):
    """The n rows of every stacked leaf, as n trees of views. In training
    their backward stacks the n rows' gradients once, where a view per row
    would add a zero-filled stacked tensor to the gradient for each row."""
    rows = [dict() for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind(v, n) if isinstance(v, dict) else v.unbind(0)
        for g in range(n):
            rows[g][k] = parts[g]
    return rows


def _merged_lora_attn(shared_attn, lora, cfg: ModelConfig):
    """Zamba2: the shared attention weights with one invocation's LoRA
    deltas merged in, in bf16, once per invocation, as the reference does:
    wq + (q_a @ q_b) and likewise k and v (not x @ wq + (x @ q_a) @ q_b,
    which rounds otherwise)."""
    if not lora:
        return shared_attn
    H, K, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    p = dict(shared_attn)
    p["wq"] = shared_attn["wq"] + (lora["q_a"] @ lora["q_b"]).reshape(D, H, hd)
    p["wk"] = shared_attn["wk"] + (lora["k_a"] @ lora["k_b"]).reshape(D, K, hd)
    p["wv"] = shared_attn["wv"] + (lora["v_a"] @ lora["v_b"]).reshape(D, K, hd)
    return p


def block_apply(p, x, *, cfg: ModelConfig, kind: str, positions,
                step_kind: str, cache=None, max_seq=None, paged=None,
                shared=None):
    """Returns (x, new_cache, aux). A recurrent block's cache is its state;
    a shared_attn block applies `shared` (the shared attention and MLP
    block, its own norms) with `p`, the invocation's LoRA, merged in. aux is
    the MoE block's auxiliary loss, None for every other kind (whose aux is
    0 in the reference)."""
    aux = None
    if kind in RECURRENT_KINDS:
        # no pageable KV: a paged decode step is an ordinary decode step
        apply = (SSM.rwkv_block_apply if kind == "rwkv"
                 else SSM.mamba_block_apply)
        x, new_cache = apply(p, x, cfg=cfg, state=cache,
                             kind="decode" if step_kind == "paged_decode"
                             else step_kind)
        return x, new_cache, aux
    if kind == "shared_attn":
        blk, attn_p = shared, _merged_lora_attn(shared["attn"], p, cfg)
    else:
        blk, attn_p = p, p["attn"]
    h = L.rms_norm(x, blk["norm1"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        h, new_cache = MLA.mla_apply(attn_p, h, cfg=cfg,
                                     positions=positions, kind=step_kind,
                                     cache=cache, max_seq=max_seq, paged=paged)
    else:
        h, new_cache = L.attention_apply(
            attn_p, h, cfg=cfg, positions=positions, kind=step_kind,
            local=(kind == "local"), cache=cache, max_seq=max_seq,
            paged=paged)
    # under a mesh each sublayer's output is pinned batch-sharded and whole
    # over the model axis (the tensor-parallel all-reduce), as the residual
    # stream is; DTensor would otherwise carry a partial sum or a sharded
    # d_model into the next sublayer
    h = constrain(h, ("batch", None, None))
    if cfg.sandwich_norm:
        h = L.rms_norm(h, blk["post_norm1"], cfg.norm_eps)
    x = x + h
    h = L.rms_norm(x, blk["norm2"], cfg.norm_eps)
    if kind == "moe":
        h, aux = MOE.moe_apply(blk["mlp"], h, cfg=cfg)
    else:
        h = L.mlp_apply(blk["mlp"], h, cfg=cfg)
    h = constrain(h, ("batch", None, None))
    if cfg.sandwich_norm:
        h = L.rms_norm(h, blk["post_norm2"], cfg.norm_eps)
    return x + h, new_cache, aux


def _stack(caches) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _blocks(params, cfg: ModelConfig):
    """(prefix, layer index, kind, block params) of every layer in order:
    the dense layers, then group g's pattern entries for each g, the
    reference's scan order."""
    for i in range(cfg.first_dense_layers):
        yield ("dense", str(i)), 0, "dense", params["dense"][str(i)]
    entries = list(zip(group_keys(cfg), cfg.pattern))
    for g, gp in enumerate(_unbind(params["groups"], cfg.num_groups)):
        for key, kind in entries:
            yield ("groups", key), g, kind, gp[key]


def _tree(cfg: ModelConfig, per_block) -> Dict[str, Any]:
    """A cache tree from one cache per block, in `_blocks` order: each
    pattern entry's caches stacked over the groups. Blocks whose cache is
    None (the sweep's attention blocks) are left out."""
    n_dense = cfg.first_dense_layers
    keys = group_keys(cfg)
    scanned = per_block[n_dense:]
    tree = {"groups": {key: _stack(scanned[i::len(keys)])
                       for i, key in enumerate(keys)
                       if scanned[i] is not None}}
    dense = {str(i): per_block[i] for i in range(n_dense)
             if per_block[i] is not None}
    if dense:
        tree["dense"] = dense
    return tree


def _block_cache(caches, prefix, g):
    """One block's cache from a tree of stacked entries: row g of each
    leaf (views) under "groups", the dense layer's own otherwise."""
    cache = caches[prefix[0]][prefix[1]]
    if prefix[0] == "groups":
        cache = {k: v[g] for k, v in cache.items()}
    return cache


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
    # under a mesh the activations start batch-sharded (XLA propagates
    # this from the tokens; DTensor picks each op's layout on its own)
    x = constrain(x, ("batch", None, None))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if pos0 is not None:
        positions = positions + pos0[:, None]
    if cfg.pos_embedding == "sinusoidal":
        x = x + L.sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    return x, positions


def train_backbone(params, x, positions, *, cfg: ModelConfig):
    """The reference's ``backbone(step_kind="train")``: the dense layers,
    then the groups, then the final norm; no cache. Returns (x, aux), aux
    the fp32 sum of the MoE blocks' auxiliary losses in the reference's
    order. With cfg.remat each group runs under one
    ``torch.utils.checkpoint``: only its input carry (x, aux) is kept, and
    the group is recomputed in the backward, as the reference's
    ``jax.checkpoint`` with ``save_only_these_names("group_carry")`` over
    its scan body. The dense layers are not rematerialized (they sit
    outside the reference's scan)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared")
    for i in range(cfg.first_dense_layers):
        x, _, _ = block_apply(params["dense"][str(i)], x, cfg=cfg,
                              kind="dense", positions=positions,
                              step_kind="train")
    entries = list(zip(group_keys(cfg), cfg.pattern))

    def group(x, aux, gp):
        if cfg.seq_shard_carry:
            x = constrain(x, ("batch", None, None))       # gather to compute
        for key, kind in entries:
            x, _, a = block_apply(gp[key], x, cfg=cfg, kind=kind,
                                  positions=positions, step_kind="train",
                                  shared=shared)
            if a is not None:
                aux = aux + a
        if cfg.seq_shard_carry:
            x = constrain(x, ("batch", "seq_model", None))  # sharded carry
        else:
            x = constrain(x, ("batch", None, None))
        return x, aux

    for gp in _unbind(params["groups"], cfg.num_groups):
        if cfg.remat:
            x, aux = checkpoint(group, x, aux, gp, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = group(x, aux, gp)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


#: weight of the MoE auxiliary (load-balance) loss in the training loss
AUX_COEF = 0.01


def loss_fn(params, batch, *, cfg: ModelConfig):
    """The training loss (reference ``loss_fn``). batch: tokens, targets
    (B, S) int, loss_mask (B, S) {0, 1} [+ frontend_embeds (B, Tf, D),
    whose positions are dropped before the loss]. Returns the fp32 scalar
    mean nll over the masked tokens + AUX_COEF * the MoE auxiliary loss."""
    fe = batch.get("frontend_embeds")
    x, positions = _embed_inputs(params, batch["tokens"], cfg,
                                 frontend_embeds=fe)
    x, aux = train_backbone(params, x, positions, cfg=cfg)
    if cfg.frontend is not None and fe is not None:
        x = x[:, fe.shape[1]:, :]
    nll = L.chunked_xent(params["embedding"], x, batch["targets"],
                         batch["loss_mask"], cfg=cfg)
    return nll + AUX_COEF * aux


def prefill_fn(params, tokens, lengths=None, *, cfg: ModelConfig,
               max_seq: Optional[int] = None, frontend_embeds=None):
    """tokens (B, T) int; lengths (B,) real tokens per right-padded row;
    frontend_embeds (B, Tf, D), prepended to the tokens where the config
    has a frontend. Returns (logits (B, V) at each row's last real token,
    caches), the cache tree of :func:`cache_specs` at seq size max_seq
    (bf16 K/V or c_kv / k_rope, idx = Tf + T; a recurrent block's state).

    The reference's quirks are kept: with a frontend prefix, `lengths`
    index the concatenated sequence (the logits are read at lengths - 1,
    not shifted by Tf); a recurrent block's state is taken at the end of
    the whole (right-padded) sequence, after the padding tokens, not at
    each row's length."""
    x, positions = _embed_inputs(params, tokens, cfg,
                                 frontend_embeds=frontend_embeds)
    B, T = x.shape[:2]
    shared = params.get("shared")
    caches = []
    for prefix, _, kind, p in _blocks(params, cfg):
        x, c, _ = block_apply(p, x, cfg=cfg, kind=kind, positions=positions,
                           step_kind="prefill", max_seq=max_seq,
                           shared=shared)
        x = _group_end(x, cfg, prefix)
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
    rows <= idx; a recurrent block reads its state from `caches` and
    returns the next one. Returns (logits (B, V), new caches): the same
    attention leaves with every idx + 1, and each recurrent entry's new
    state, stacked over the groups (new tensors)."""
    x, positions = _embed_inputs(params, batch["tokens"], cfg,
                                 pos0=batch["pos0"])
    shared = params.get("shared")
    states = []
    for prefix, g, kind, p in _blocks(params, cfg):
        x, nc, _ = block_apply(p, x, cfg=cfg, kind=kind, positions=positions,
                            step_kind="decode",
                            cache=_block_cache(caches, prefix, g),
                            shared=shared)
        x = _group_end(x, cfg, prefix)
        states.append(nc if kind in RECURRENT_KINDS else None)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.logits_apply(params["embedding"], x, cfg=cfg)[:, 0, :]
    new = {top: {key: ({**blk, "idx": blk["idx"] + 1} if "idx" in blk
                       else blk)
                 for key, blk in sub.items()}
           for top, sub in caches.items()}
    new["groups"].update(_tree(cfg, states)["groups"])
    return logits, new


def paged_decode_fn(params, batch, caches=None, planes=None, *,
                    cfg: ModelConfig, pul_distance: int = 4):
    """Kernel-true paged decode step: attention reads KV pages directly.

    batch: tokens (B, 1), pos0 (B,) absolute position of the new token,
    lengths (B,) int32 cached tokens per slot, page_table (B, n_pages) int32
    physical frame of each slot's logical page.

    **Single sweep** (`planes` = the layout's plane dict, batch also carries
    frames/offsets (B,) int32): every attention layer runs the sweep kernel
    (K1, or K3 for MLA) on the full planes and commits the current token's
    rows in place. `caches` holds only the recurrent entries' state (None
    without them). Returns (logits (B, V), the recurrent entries' new state
    or None).

    **Per layer** (`caches` = the layout's page-view tree, with the
    recurrent entries' state beside it; planes None): every attention layer
    runs K2 (K4 for MLA) over its own frames; returns (logits, new_caches)
    whose pageable leaves hold ONLY the current token's rows — (L, B, ...)
    for each pattern entry, (B, ...) for a dense layer — for the engine to
    commit (`KVPagePool.write_rows`), and whose recurrent entries hold the
    new state.

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
    shared = params.get("shared")
    new = []
    for prefix, g, kind, p in _blocks(params, cfg):
        if kind in RECURRENT_KINDS:
            cache, paged = _block_cache(caches, prefix, g), None
        elif sweep is not None:
            sweep.prefix, sweep.layer = prefix, g
            cache, paged = None, sweep
        else:
            cache = {**_block_cache(caches, prefix, g), "idx": lengths}
            paged = (batch["page_table"], pul_cfg)
        x, nc, _ = block_apply(p, x, cfg=cfg, kind=kind, positions=positions,
                            step_kind="paged_decode", cache=cache, paged=paged,
                            shared=shared)
        x = _group_end(x, cfg, prefix)
        new.append(nc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.logits_apply(params["embedding"], x, cfg=cfg)[:, 0, :]
    tree = _tree(cfg, new)
    if sweep is not None and not tree["groups"]:
        return logits, None
    return logits, tree
