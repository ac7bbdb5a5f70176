"""Analytic execution-cost model per (arch x shape) cell (port of the
reference's ``benchmarks/flops.py``; pure arithmetic over ``ModelConfig``
and ``InputShape``, which ``repro_torch.configs.base`` copies).

Why analytic: a compiled program's cost counter counts a scanned layer
body once, so for scanned-layer / microbatched / chunked programs it
underestimates by the trip counts. This model counts every product the
model code executes, per cell:

  MODEL_FLOPS  = 6 * N_active * tokens  (train)  |  2 * N_active * tokens
                 (prefill/decode)  — the "useful" MFU numerator.
  EXEC_FLOPS   = what the hardware runs: + causal-block overcompute in the
                 streaming attention, + MoE dispatch einsums (backend-aware),
                 + remat recompute (x4/3 of fwd), + chunked-loss logits.
  EXEC_BYTES   = HBM traffic: parameter shard reads per microbatch, gathered
                 weight write+read, optimizer state r/w (train); KV-cache
                 read per step (decode); activation stack save+load.

All numbers are GLOBAL (whole job); divide by chips for per-device terms.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import InputShape, ModelConfig

BF16 = 2
F32 = 4


def _attn_flops_per_layer(cfg: ModelConfig, B: int, T: int, S_ctx: int,
                          *, window=None) -> Dict[str, float]:
    """Forward FLOPs of one attention layer over a (B, T) query block
    attending to S_ctx keys. Streaming attention computes full blocks under
    the causal mask -> score/out term uses S_ctx (not S_ctx/2)."""
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S_eff = min(window, S_ctx) if window else S_ctx
    proj = 2 * B * T * D * (H + 2 * K) * hd + 2 * B * T * H * hd * D
    scores = 2 * B * H * T * S_eff * hd * 2          # qk^T and p@v
    return {"proj": proj, "scores": scores}


def _mla_flops_per_layer(cfg: ModelConfig, B: int, T: int, S_ctx: int,
                         decode: bool) -> Dict[str, float]:
    D, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    proj = 2 * B * T * (D * qr + qr * H * (dn + dr)        # q path
                        + D * (kvr + dr))                  # kv compress
    if decode:
        # absorbed: q_abs (H,dn,kvr), scores over (kvr + dr), out over kvr,
        # then v up-proj per head
        proj += 2 * B * T * H * (dn * kvr + dv * kvr)
        scores = 2 * B * H * T * S_ctx * (kvr + dr) * 2
    else:
        proj += 2 * B * T * kvr * H * (dn + dv)            # kv up-proj
        scores = 2 * B * H * T * S_ctx * ((dn + dr) + dv)
    proj += 2 * B * T * H * dv * D                         # out proj
    return {"proj": proj, "scores": scores}


def _mlp_flops(cfg: ModelConfig, B: int, T: int, d_ff: int) -> float:
    mult = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    return 2 * B * T * cfg.d_model * d_ff * mult


def _moe_flops(cfg: ModelConfig, B: int, T: int) -> Dict[str, float]:
    D, E, k = cfg.d_model, cfg.num_experts, cfg.experts_per_tok
    F = cfg.moe_d_ff
    router = 2 * B * T * D * E
    experts = 2 * B * T * k * D * F * 3
    shared = 2 * B * T * D * (cfg.num_shared_experts * F) * 3 \
        if cfg.num_shared_experts else 0.0
    dispatch = 0.0
    if cfg.moe_backend == "einsum":
        Tg = 2048
        import math
        C = max(8, -(-math.ceil(Tg * k / E * cfg.capacity_factor) // 8) * 8)
        # dispatch + combine einsums (td,tec->ecd / ecd,tec->td) per group
        dispatch = 2 * (2 * Tg * E * C * D) * (B * T / Tg)
    return {"router": router, "experts": experts + shared,
            "dispatch": dispatch}


def _rwkv_flops_per_layer(cfg: ModelConfig, B: int, T: int, decode: bool) -> float:
    D, H, N = cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim
    C = 1 if decode else cfg.chunk_size
    proj = 2 * B * T * D * (4 * H * N) + 2 * B * T * (D * 64 + 64 * H * N)
    wkv = B * T * H * (3 * C * N + 2 * C * N + 4 * N * N)   # intra + inter/state
    cmix = 2 * B * T * (D * cfg.d_ff + cfg.d_ff * D + D * D)
    out = 2 * B * T * H * N * D
    return proj + wkv + cmix + out


def _mamba_flops_per_layer(cfg: ModelConfig, B: int, T: int, decode: bool) -> float:
    D, din, H, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    P = din // H
    C = 1 if decode else cfg.chunk_size
    proj = 2 * B * T * D * (2 * din + 2 * N + H) + 2 * B * T * din * D
    conv = 2 * B * T * (din + 2 * N) * cfg.conv_kernel
    ssd = B * T * H * (3 * C * N + 2 * C * P + 4 * P * N)
    return proj + conv + ssd


def _layer_fwd_flops(cfg: ModelConfig, kind: str, B: int, T: int, S_ctx: int,
                     decode: bool) -> float:
    if kind == "rwkv":
        return _rwkv_flops_per_layer(cfg, B, T, decode)
    if kind == "mamba":
        return _mamba_flops_per_layer(cfg, B, T, decode)
    total = 0.0
    if cfg.attn_type == "mla":
        total += sum(_mla_flops_per_layer(cfg, B, T, S_ctx, decode).values())
    else:
        window = cfg.sliding_window if kind == "local" else None
        total += sum(_attn_flops_per_layer(cfg, B, T, S_ctx,
                                           window=window).values())
    if kind == "moe":
        total += sum(_moe_flops(cfg, B, T).values())
    elif kind == "shared_attn":
        total += _mlp_flops(cfg, B, T, cfg.d_ff)
        # LoRA merge: (D,r)@(r,HK*hd) x3, amortized per invocation
        r = cfg.shared_lora_rank
        if r:
            D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            total += 2 * D * r * (H + 2 * K) * hd
    else:
        total += _mlp_flops(cfg, B, T, cfg.d_ff)
    return total


def active_params(cfg: ModelConfig) -> float:
    """N_active: parameters that multiply activations per token (experts
    counted at top-k), embedding gather excluded, lm_head included."""
    D = cfg.d_model
    n = 0.0
    for kind in cfg.pattern:
        if kind == "rwkv":
            H, N = cfg.ssm_heads, cfg.ssm_head_dim
            n += D * 4 * H * N + D * 64 + 64 * H * N + H * N * D
            n += D * cfg.d_ff * 2 + D * D
        elif kind == "mamba":
            n += D * (2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads)
            n += cfg.d_inner * D
        else:
            if cfg.attn_type == "mla":
                qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
                dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                              cfg.v_head_dim)
                H = cfg.num_heads
                n += D * qr + qr * H * (dn + dr) + D * (kvr + dr) \
                    + kvr * H * (dn + dv) + H * dv * D
            else:
                H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
                n += D * (H + 2 * K) * hd + H * hd * D
            mult = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
            if kind == "moe":
                n += D * cfg.num_experts * 0  # routed: only top-k active
                n += cfg.experts_per_tok * D * cfg.moe_d_ff * mult
                n += cfg.num_shared_experts * D * cfg.moe_d_ff * mult
                n += D * cfg.num_experts    # router
            else:
                n += D * cfg.d_ff * mult
    n *= cfg.num_groups
    # unscanned dense prefix
    if cfg.first_dense_layers:
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if cfg.attn_type == "mla":
            qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
            dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
            attn = D * qr + qr * cfg.num_heads * (dn + dr) + D * (kvr + dr) \
                + kvr * cfg.num_heads * (dn + dv) + cfg.num_heads * dv * D
        else:
            attn = D * (H + 2 * K) * hd + H * hd * D
        mult = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        n += cfg.first_dense_layers * (attn + D * cfg.d_ff * mult)
    n += cfg.vocab_size * D       # lm_head
    return n


def total_params(cfg: ModelConfig) -> float:
    """Every parameter of the model's tree (shapes only; nothing is
    allocated)."""
    from repro_torch.models.module import count_params
    from repro_torch.models.transformer import model_params
    return float(count_params(model_params(cfg)))


@dataclasses.dataclass(frozen=True)
class CellCost:
    model_flops: float            # 6ND / 2ND (global)
    exec_flops: float             # what actually runs (global)
    exec_bytes: float             # HBM traffic (global)
    tokens: float
    notes: str = ""


def cell_cost(cfg: ModelConfig, shape: InputShape, accum: int = 0) -> CellCost:
    B_, S_ = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    train = shape.kind == "train"
    accum = accum or cfg.train_accum
    Tf = cfg.frontend_tokens if cfg.frontend else 0
    T = 1 if decode else S_                 # query tokens per sequence
    S_ctx = S_                              # context length
    tokens = B_ * T

    # ---- forward flops over all layers
    fwd = 0.0
    for kind in cfg.pattern:
        fwd += _layer_fwd_flops(cfg, kind, B_, T, S_ctx, decode) * cfg.num_groups / 1.0
    if cfg.first_dense_layers:
        fwd += _layer_fwd_flops(cfg, "dense", B_, T, S_ctx, decode) \
            * cfg.first_dense_layers
    # logits: chunked loss (train) or full head (prefill last tok / decode)
    Vp = -(-cfg.vocab_size // cfg.vocab_chunk) * cfg.vocab_chunk
    if train:
        fwd += 2 * B_ * T * cfg.d_model * Vp
    else:
        fwd += 2 * B_ * 1 * cfg.d_model * cfg.vocab_size

    # ---- execution multiplier
    if train:
        exec_flops = fwd * 4.0              # fwd + remat-refwd + 2x bwd
    else:
        exec_flops = fwd

    N_act = active_params(cfg)
    model_flops = (6.0 if train else 2.0) * N_act * tokens

    # ---- bytes (HBM, global)
    N_tot = total_params(cfg)
    if train:
        # per microbatch: param shard read + gathered write + gathered read;
        # optimizer: m,v read+write fp32 + param write
        p_traffic = accum * 3 * N_tot * BF16 + N_tot * (4 * F32 + BF16)
        # activation residual stack: save + load (bf16 + the f32 artifact)
        layer_saves = cfg.num_groups * B_ * S_ * cfg.d_model * (BF16 + F32)
        a_traffic = 2 * layer_saves
        exec_bytes = p_traffic + a_traffic
    elif decode:
        cache = _cache_bytes(cfg, B_, S_)
        exec_bytes = N_tot * BF16 + cache   # read weights + read cache
    else:  # prefill
        cache = _cache_bytes(cfg, B_, S_)
        act = cfg.num_layers * B_ * S_ * cfg.d_model * BF16 * 4
        exec_bytes = N_tot * BF16 + cache + act
    return CellCost(model_flops=model_flops, exec_flops=exec_flops,
                    exec_bytes=float(exec_bytes), tokens=tokens)


def collective_bytes(cfg: ModelConfig, shape: InputShape, accum: int = 0,
                     *, fsdp: int = 16, tp: int = 16,
                     inference_replicated: bool = False) -> float:
    """Analytic per-DEVICE collective wire bytes per step.

    Needed because a compiled program's counter counts collectives inside
    a scanned body once (as for flops); this model multiplies by the real
    trip counts. Dominant flows:
      train:   FSDP all-gather of weights (fwd + remat-bwd) and
               reduce-scatter of grads, PER MICROBATCH; TP all-reduce of
               activations per layer (fwd+bwd).
      serve:   one weight all-gather per step (unless weights are
               replicated across the data axis) + TP reductions.
    """
    accum = accum or cfg.train_accum
    B_, S_ = shape.global_batch, shape.seq_len
    T = 1 if shape.kind == "decode" else S_
    P = total_params(cfg) * BF16
    ag = P * (fsdp - 1) / fsdp          # one full weight gather, per device
    # TP activation all-reduce: ~2 tensors of (B,T,D) per layer boundary
    act = 2 * B_ * T * cfg.d_model * BF16 * cfg.num_layers * (tp - 1) / tp / tp
    if shape.kind == "train":
        per_micro = 2 * ag + ag         # AG fwd + AG remat-bwd + RS grads
        return accum * (per_micro + 3 * act) / 1.0
    weights = 0.0 if inference_replicated else ag
    return weights + act


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    total = 0.0
    for kind in cfg.pattern:
        if kind == "rwkv":
            H, N = cfg.ssm_heads, cfg.ssm_head_dim
            total += B * (H * N * N * F32 + 2 * cfg.d_model * BF16)
        elif kind == "mamba":
            H, N = cfg.ssm_heads, cfg.ssm_state
            P = cfg.d_inner // H
            total += B * (H * P * N * F32
                          + (cfg.conv_kernel - 1) * (cfg.d_inner + 2 * N) * BF16)
        else:
            if cfg.attn_type == "mla":
                total += B * S * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * BF16
            else:
                win = cfg.sliding_window if kind == "local" else None
                S_eff = min(win, S) if win else S
                total += B * S_eff * 2 * cfg.num_kv_heads * cfg.head_dim * BF16
    total *= cfg.num_groups
    if cfg.first_dense_layers:
        if cfg.attn_type == "mla":
            total += cfg.first_dense_layers * B * S * \
                (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * BF16
        else:
            total += cfg.first_dense_layers * B * S * 2 * cfg.num_kv_heads \
                * cfg.head_dim * BF16
    return total
