"""Multi-head Latent Attention of the port (``repro/models/mla.py``,
DeepSeek-V2).

Prefill runs the decompressed path: c_kv is up-projected to per-head keys
and values and attended like standard attention (plain torch, as the
reference's jnp). Paged decode runs the absorbed path: the k up-projection
is folded into the query (q_abs) and the v up-projection applied after the
attention, which runs straight over the compressed (c_kv, k_rope) pages
through the port's CUDA kernels K3 (single sweep, fused commit) and K4 (per
layer). The cache holds kv_lora + rope = 576 features per token.

Not ported here: the dense ``kind="decode"`` branch (the dense
``ServingEngine``, ROADMAP) and prefill past 2 * KV_BLOCK tokens (the
reference's streamed ``_attend_chunked``); both raise.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    KV_BLOCK,
    NEG_INF,
    PagedSweep,
    rms_norm,
    rms_norm_params,
    rope,
)
from repro_torch.models.module import Param


def mla_params(cfg: ModelConfig) -> Dict[str, Any]:
    D, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = torch.bfloat16
    return {
        "wq_a": Param((D, qr), ("embed", "q_rank"), dt, "fan_in"),
        "q_norm": rms_norm_params(qr),
        "wq_b": Param((qr, H, dn + dr), ("q_rank", "heads", "head_dim"), dt, "fan_in"),
        "wkv_a": Param((D, kvr + dr), ("embed", "kv_rank"), dt, "fan_in"),
        "kv_norm": rms_norm_params(kvr),
        "wkv_b": Param((kvr, H, dn + dv), ("kv_rank", "heads", "head_dim"), dt, "fan_in"),
        "wo": Param((H, dv, D), ("heads", "head_dim", "embed"), dt, "fan_in"),
    }


def _project_q(p, x, cfg: ModelConfig, positions):
    dn = cfg.qk_nope_head_dim
    q_c = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = torch.einsum("btr,rhk->bthk", q_c, p["wq_b"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _compress_kv(p, x, cfg: ModelConfig, positions):
    kvr = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]
    c_kv = rms_norm(kv[..., :kvr], p["kv_norm"], cfg.norm_eps)
    k_rope = rope(kv[..., kvr:][:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_apply(p, x, *, cfg: ModelConfig, positions, kind: str,
              cache: Optional[Dict[str, Any]] = None,
              max_seq: Optional[int] = None, paged=None):
    """Returns (y, new_cache).

    kind="prefill": the decompressed causal attention; the cache holds c_kv
    (B, max_seq, kvr) and k_rope (B, max_seq, dr) bf16 and idx (B,) = T.
    kind="paged_decode": one token per slot over compressed pages. `paged`
    is a :class:`PagedSweep` (K3 reads plane row `paged.layer` of the c_kv /
    k_rope planes and commits the token in place; new_cache is None) or a
    (page_table, PULConfig) pair with `cache` = {"c_kv": (NF, P, kvr),
    "k_rope": (NF, P, dr) one layer's frames, "idx": (B,)} (K4; new_cache
    holds the token's compressed rows for the engine to commit)."""
    B, T, D = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    scale = 1.0 / math.sqrt(dn + dr)
    q_nope, q_rope = _project_q(p, x, cfg, positions)

    if kind == "paged_decode":
        from repro_torch.kernels.pul_attention import (
            pul_paged_mla_decode_attention, pul_paged_sweep_mla_decode_attention)
        if T != 1:
            raise ValueError("paged decode processes one token per step")
        c_new, r_new = _compress_kv(p, x, cfg, positions)
        c_new, r_new = c_new[:, 0].contiguous(), r_new[:, 0].contiguous()
        wkv_b_k = p["wkv_b"][..., :dn]                      # (kvr, H, dn)
        wkv_b_v = p["wkv_b"][..., dn:]                      # (kvr, H, dv)
        q_abs = torch.einsum("bthn,rhn->bthr", q_nope, wkv_b_k)[:, 0].contiguous()
        qr1 = q_rope[:, 0].contiguous()
        if isinstance(paged, PagedSweep):
            o_c = pul_paged_sweep_mla_decode_attention(
                q_abs, qr1, paged.plane("c_kv"), paged.plane("k_rope"),
                paged.layer, paged.page_table, paged.lengths, c_new, r_new,
                paged.frames, paged.offsets, scale=scale, cfg=paged.pul_cfg)
            new_cache = None
        else:
            page_table, pul_cfg = paged
            o_c = pul_paged_mla_decode_attention(
                q_abs, qr1, cache["c_kv"], cache["k_rope"], page_table,
                cache["idx"], c_new, r_new, scale=scale, cfg=pul_cfg)
            new_cache = {"c_kv": c_new, "k_rope": r_new, "idx": cache["idx"] + 1}
        out = torch.einsum("bhr,rhv->bhv", o_c, wkv_b_v)[:, None]
    elif kind == "prefill":
        if T > 2 * KV_BLOCK:
            raise NotImplementedError(
                f"prefill of {T} tokens needs the streamed (chunked) "
                "attention, not ported yet")
        c_kv, k_rope = _compress_kv(p, x, cfg, positions)
        kv = torch.einsum("btr,rhk->bthk", c_kv, p["wkv_b"])
        k_nope, v = kv[..., :dn], kv[..., dn:]
        H = k_nope.shape[2]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, dr)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        logits = torch.einsum("bthk,bshk->bhts", q, k).float() * scale
        iq = torch.arange(T, device=x.device)
        mask = (iq[:, None] >= iq[None, :])[None, None]
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhts,bshv->bthv", probs, v)
        target = max_seq or T
        if T > target:
            raise ValueError(f"prompt of {T} tokens exceeds max_seq {target}")
        new_cache = {"c_kv": F.pad(c_kv, (0, 0, 0, target - T)).to(torch.bfloat16),
                     "k_rope": F.pad(k_rope, (0, 0, 0, target - T)).to(torch.bfloat16),
                     "idx": torch.full((B,), T, dtype=torch.int32,
                                       device=x.device)}
    else:
        raise NotImplementedError(
            f"MLA kind {kind!r} is not ported (the dense decode belongs to the "
            "dense ServingEngine, ROADMAP)")
    y = torch.einsum("bthv,hvd->btd", out, p["wo"])
    return y, new_cache


def mla_cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
    """Decode-cache leaves as (shape, dtype)."""
    return {"c_kv": ((batch, max_seq, cfg.kv_lora_rank), torch.bfloat16),
            "k_rope": ((batch, max_seq, cfg.qk_rope_head_dim), torch.bfloat16),
            "idx": ((batch,), torch.int32)}
