"""Transformer layers of the port (``repro/models/layers.py``): norms, RoPE
and sinusoidal positions, GQA attention for prefill and paged decode, the
gated and plain GELU MLPs, embedding and logits.

Plain functions on tensors over a param dict. The reference's bf16 rounding
points are kept: projections and the head are bf16 products, norms and RoPE
run in fp32 and round back, and prefill attention rounds q·kᵀ to bf16
before the fp32 cast, scale and softmax, then casts the probabilities to
bf16 (`_attend`). A prompt of more than 2 * KV_BLOCK tokens streams its
attention over KV blocks with an online softmax (`_attend_chunked`), as the
reference does. A local layer attends within cfg.sliding_window in every
step: the prefill's mask, the paged kernels' window, the dense decode's
ring (or its mask on a token-indexed cache). Prefill and dense-cache
decode attention are plain torch ops: in the reference they are jnp, not
Pallas kernels. Paged decode attention goes through the port's CUDA
kernels (``kernels.pul_attention``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import Param

NEG_INF = -2.0e38  # large finite; avoids nan from (-inf) - (-inf)
# KV-block length of the streamed prefill attention (`_attend_chunked`),
# which prompts of more than 2 * KV_BLOCK tokens take, as in the reference
KV_BLOCK = 1024


class PagedSweep:
    """Routing context for the single-sweep paged decode.

    The backbone sets `prefix` to the current block's plane path and `layer`
    to the layer index; the attention block reads its planes via
    :meth:`plane` and calls the sweep kernel, which selects the layer itself
    and commits the current token's rows in its epilogue — in place, so the
    planes dict needs no write-back. `lengths` ((B,) int32) are the slots'
    cached tokens; `frames`/`offsets` ((B,) int32) name each slot's
    tail-page commit position (TRASH frame for inactive slots).
    """

    def __init__(self, page_table, lengths, pul_cfg, frames, offsets, planes):
        self.page_table = page_table
        self.lengths = lengths
        self.pul_cfg = pul_cfg
        self.frames = frames
        self.offsets = offsets
        self.planes = planes        # {plane_key: (L, NF, ...) full plane}
        self.prefix: Tuple[str, ...] = ()
        self.layer = 0

    def plane(self, leaf: str) -> torch.Tensor:
        return self.planes["/".join((*self.prefix, leaf))]


# --------------------------------------------------------------------------
# norms / positions
# --------------------------------------------------------------------------
def rms_norm_params(dim: int, name_axis: str = "norm") -> Param:
    return Param((dim,), (name_axis,), dtype=torch.float32, init="zeros")


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with gemma-style (1 + scale) parameterization (zero init)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope(x, positions, theta: float):
    """Half-split rotary embedding in fp32. x: (..., seq, n, head_dim),
    positions broadcastable to (..., seq)."""
    dt = x.dtype
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:2 * half].float()
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if hd != 2 * half:
        rot = torch.cat([rot, x[..., 2 * half:].float()], dim=-1)
    return rot.to(dt)


def sinusoidal_embedding(positions, dim: int, max_scale: float = 1e4):
    """Absolute sinusoidal position embedding (musicgen), fp32 [sin | cos]:
    positions (B, S) -> (B, S, dim); the caller casts it to the
    activations' type before the add, as the reference does."""
    half = dim // 2
    freqs = max_scale ** (-torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def attention_params(cfg: ModelConfig) -> Dict[str, Any]:
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = torch.bfloat16
    p: Dict[str, Any] = {
        "wq": Param((D, H, hd), ("embed", "heads", "head_dim"), dt, "fan_in"),
        "wk": Param((D, K, hd), ("embed", "kv_heads", "head_dim"), dt, "fan_in"),
        "wv": Param((D, K, hd), ("embed", "kv_heads", "head_dim"), dt, "fan_in"),
        "wo": Param((H, hd, D), ("heads", "head_dim", "embed"), dt, "fan_in"),
    }
    if cfg.qkv_bias:
        p["bq"] = Param((H, hd), ("heads", "head_dim"), dt, "zeros")
        p["bk"] = Param((K, hd), ("kv_heads", "head_dim"), dt, "zeros")
        p["bv"] = Param((K, hd), ("kv_heads", "head_dim"), dt, "zeros")
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_params(hd)
        p["k_norm"] = rms_norm_params(hd)
    return p


def _attend(q, k, v, *, mask, softcap: Optional[float], scale: float):
    """q: (B,T,H,hd) k/v: (B,S,K,hd); grouped-query attention core."""
    B, T, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q = q.reshape(B, T, K, G, hd)
    logits = torch.einsum("btkgh,bskh->bkgts", q, k).float() * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(B, T, H, hd)


def _attend_chunked(q, k, v, *, softcap: Optional[float], scale: float,
                    window: Optional[int], kv_block: int = KV_BLOCK):
    """Causal GQA attention streamed over KV blocks with an online softmax
    (the reference's ``lax.scan``, here a Python loop over the blocks).

    q: (B, T, H, hd), k: (B, S, K, hd), v: (B, S, K, vd) with T == S; vd
    may differ from hd (MLA). The reference's rounding points: q·kᵀ is a
    bf16 product cast to fp32 and scaled, the softcap comes before the
    mask, the softmax runs in fp32 and p stays fp32 in the p·v product (JAX
    promotes v there), and the result is cast back to v's type. Peak memory
    is O(T * kv_block) per head, never (T, S); the block's logits are
    updated in place, which rounds as the out-of-place ops do."""
    B, T, H, hd = q.shape
    S, K, vd = k.shape[1], k.shape[2], v.shape[-1]
    G = H // K
    nb = -(-S // kv_block)
    pad = nb * kv_block - S
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, T, K, G, hd)
    iq = torch.arange(T, device=q.device)[:, None]        # absolute = iq (T == S)
    m = torch.full((B, K, G, T), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, T, vd), dtype=torch.float32, device=q.device)
    for off in range(0, nb * kv_block, kv_block):
        kc, vc = k[:, off:off + kv_block], v[:, off:off + kv_block]
        logits = torch.einsum("btkgh,bskh->bkgts", qg, kc).float().mul_(scale)
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        jk = off + torch.arange(kv_block, device=q.device)[None, :]
        msk = (jk <= iq) & (jk < S)
        if window is not None:
            msk &= jk > iq - window
        logits.masked_fill_(~msk, NEG_INF)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - new_m)
        p = logits.sub_(new_m[..., None]).exp_()
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgts,bskh->bkgth", p,
                                                   vc.float())
        m = new_m
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, vd).to(v.dtype)


def _causal_mask(tq: int, tk: int, *, window: Optional[int], device):
    iq = torch.arange(tq, device=device)[:, None]
    jk = torch.arange(tk, device=device)[None, :]
    m = jk <= iq
    if window is not None:
        m = m & (jk > iq - window)
    return m[None, None, None]


def attention_apply(p, x, *, cfg: ModelConfig, positions, kind: str,
                    local: bool = False,
                    cache: Optional[Dict[str, Any]] = None,
                    max_seq: Optional[int] = None, paged=None):
    """Returns (y, new_cache).

    A local layer (`local`) attends over the last cfg.sliding_window
    positions (key j visible to query i when i - window < j <= i) and
    rotates by cfg.local_rope_theta where the config sets one.
    kind="prefill": causal attention over the prompt; the cache holds k/v
    (B, max_seq, K, hd) bf16 and idx (B,) = T. A local layer's cache is a
    ring of min(window, max_seq) rows unless cfg.paged_kv: the last rows
    of the prompt, token t at row t % rows.
    kind="decode": one token per slot over a dense cache {"k", "v":
    (B, S, K, hd), "idx": (B,) per-slot fill}; the token's K/V rows are
    written IN PLACE at row idx % S of `cache` (the port's counterpart of
    the reference's functional update), and new_cache holds the same
    tensors with idx + 1. On a ring the overwrite is the window; a local
    layer's token-indexed cache (cfg.paged_kv, S > window) masks the rows
    at or before idx - window.
    kind="paged_decode": one token per slot over KV pages. `paged` is a
    :class:`PagedSweep` (single sweep: K1 reads plane row `paged.layer` and
    commits the token in place; new_cache is None) or a (page_table,
    PULConfig) pair with `cache` = {"k", "v": (NF, K, P, hd) one layer's
    frames, "idx": (B,)} (per layer: K2; new_cache holds the token's rows
    for the engine to commit)."""
    B, T, D = x.shape
    hd = cfg.head_dim
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    theta = cfg.rope_theta
    if local and cfg.local_rope_theta is not None:
        theta = cfg.local_rope_theta
    if cfg.pos_embedding == "rope":
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    scale = 1.0 / math.sqrt(hd)
    window = cfg.sliding_window if local else None

    if kind == "paged_decode":
        from repro_torch.kernels.pul_attention import (
            pul_paged_decode_attention, pul_paged_sweep_decode_attention)
        if T != 1:
            raise ValueError("paged decode processes one token per step")
        q1 = q[:, 0].contiguous()
        k_new = k[:, 0].contiguous()
        v_new = v[:, 0].contiguous()
        if isinstance(paged, PagedSweep):
            out = pul_paged_sweep_decode_attention(
                q1, paged.plane("k"), paged.plane("v"), paged.layer,
                paged.page_table, paged.lengths, k_new, v_new, paged.frames,
                paged.offsets, scale=scale, softcap=cfg.attn_softcap,
                window=window, cfg=paged.pul_cfg)
            new_cache = None
        else:
            page_table, pul_cfg = paged
            out = pul_paged_decode_attention(
                q1, cache["k"], cache["v"], page_table, cache["idx"],
                scale=scale, softcap=cfg.attn_softcap, window=window,
                k_new=k_new, v_new=v_new, cfg=pul_cfg)
            new_cache = {"k": k_new, "v": v_new, "idx": cache["idx"] + 1}
        out = out[:, None]
    elif kind == "decode":
        # per-slot fill levels: slot b's token goes to row idx[b] % S, and
        # rows <= idx[b] are visible; a ring (S rows of a local layer) is
        # the window itself, a token-indexed local cache masks it
        if T != 1:
            raise ValueError("decode processes one token per step")
        idx = cache["idx"]
        kc, vc = cache["k"], cache["v"]
        S = kc.shape[1]
        rows = torch.arange(B, device=x.device)
        write = idx.long() % S
        kc[rows, write] = k[:, 0].to(kc.dtype)
        vc[rows, write] = v[:, 0].to(vc.dtype)
        jk = torch.arange(S, device=x.device)[None, :]
        mask = jk <= idx.long()[:, None]
        if cfg.paged_kv and window is not None and S > window:
            mask = mask & (jk > idx.long()[:, None] - window)
        out = _attend(q, kc, vc, mask=mask[:, None, None, None, :],
                      softcap=cfg.attn_softcap, scale=scale)
        new_cache = {"k": kc, "v": vc, "idx": idx + 1}
    elif kind == "prefill":
        if T > 2 * KV_BLOCK:
            out = _attend_chunked(q, k, v, softcap=cfg.attn_softcap,
                                  scale=scale, window=window)
        else:
            mask = _causal_mask(T, T, window=window, device=x.device)
            out = _attend(q, k, v, mask=mask, softcap=cfg.attn_softcap,
                          scale=scale)
        target = max_seq or T
        ring = window is not None and not cfg.paged_kv
        if ring:
            target = min(window, target)
        kc, vc = k, v
        if T > target:
            if not ring:
                raise ValueError(
                    f"prompt of {T} tokens exceeds max_seq {target}")
            # the last `target` tokens, ring-aligned (token t at row t % W)
            o = T % target
            kc = torch.roll(k[:, T - target:], o, dims=1)
            vc = torch.roll(v[:, T - target:], o, dims=1)
        elif T < target:
            kc = F.pad(k, (0, 0, 0, 0, 0, target - T))
            vc = F.pad(v, (0, 0, 0, 0, 0, target - T))
        new_cache = {"k": kc.to(torch.bfloat16), "v": vc.to(torch.bfloat16),
                     "idx": torch.full((B,), T, dtype=torch.int32,
                                       device=x.device)}
    else:
        raise NotImplementedError(f"attention kind {kind!r} is not ported")
    y = torch.einsum("bthk,hkd->btd", out, p["wo"])
    return y, new_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def mlp_params(cfg: ModelConfig) -> Dict[str, Any]:
    D, Fd = cfg.d_model, cfg.d_ff
    dt = torch.bfloat16
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": Param((D, Fd), ("embed", "ff"), dt, "fan_in"),
            "w_up": Param((D, Fd), ("embed", "ff"), dt, "fan_in"),
            "w_down": Param((Fd, D), ("ff", "embed"), dt, "fan_in"),
        }
    if cfg.mlp_type == "gelu":
        return {
            "w_in": Param((D, Fd), ("embed", "ff"), dt, "fan_in"),
            "w_out": Param((Fd, D), ("ff", "embed"), dt, "fan_in"),
        }
    raise NotImplementedError(f"mlp_type {cfg.mlp_type} is not ported")


def mlp_apply(p, x, *, cfg: ModelConfig):
    """Gated (swiglu, geglu) or plain (gelu, musicgen's) MLP; GELU is the
    tanh approximation, as the reference's ``approximate=True``."""
    if cfg.mlp_type == "gelu":
        return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]
    act = F.silu if cfg.mlp_type == "swiglu" else (
        lambda t: F.gelu(t, approximate="tanh"))
    h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# --------------------------------------------------------------------------
# embedding + logits
# --------------------------------------------------------------------------
def embedding_params(cfg: ModelConfig) -> Dict[str, Any]:
    V = cfg.padded_vocab
    p = {"table": Param((V, cfg.d_model), ("vocab", "embed"), torch.bfloat16,
                        "embed")}
    if not cfg.tie_embeddings:
        p["lm_head"] = Param((V, cfg.d_model), ("vocab", "embed"),
                             torch.bfloat16, "fan_in", scale=0.02)
    return p


def embed_apply(p, tokens, *, cfg: ModelConfig):
    x = p["table"][tokens]
    if cfg.embed_scale:
        # a device scalar: no host tensor enters a captured decode step
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return x


def logits_apply(p, x, *, cfg: ModelConfig):
    """Full logits (B, T, vocab_size) in fp32 from a bf16 head product."""
    w = p["table"] if cfg.tie_embeddings else p["lm_head"]
    logits = torch.einsum("btd,vd->btv", x, w).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits[..., :cfg.vocab_size]
