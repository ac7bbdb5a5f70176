"""Transformer layers of the port (``repro/models/layers.py``): norms, RoPE
and sinusoidal positions, GQA attention for training, prefill and paged
decode, the gated and plain GELU MLPs, embedding, logits and the chunked
cross-entropy of training (`chunked_xent`).

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
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import Param
from repro_torch.runtime.sharding import (constrain, current_mesh,
                                          is_dtensor, logical_to_spec,
                                          split_dims)

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


def _heads_split(logical: str, n: int, mesh) -> bool:
    """Whether the sharding rules split n heads of `logical` ("act_heads",
    "act_kv_heads") over some axis of `mesh` (one of size 1 included), as
    ``constrain`` lays them out."""
    return bool(logical_to_spec((logical,), (n,), mesh))


def _project(x, w, logical: str):
    """x (B, T, D) through w (D, n, d) -> (B, T, n, d), "btd,dhk->bthk".
    Under a mesh where the rules leave the n heads of `logical` whole (8 kv
    heads on a 16-way model axis), DTensor may shard the einsum's flattened
    (n * d) output over a mesh axis and then cannot split it into heads:
    there the product runs as a matmul whose output is pinned whole over
    all but the batch axes before the split. Elsewhere (no mesh, heads the
    rules split, a 1x1 mesh) it is the einsum."""
    mesh = current_mesh()
    n = w.shape[1]
    if mesh is None or _heads_split(logical, n, mesh):
        return torch.einsum("btd,dhk->bthk", x, w)
    B, T, D = x.shape
    w2 = constrain(w.reshape(D, -1), ("embed", None))
    y = constrain(x @ w2, ("batch", None, None))
    return y.reshape(B, T, n, -1)


def _heads_for_mesh(q, k, v):
    """(q, k, v) as the attention core takes them under a mesh; as they are
    outside one, or where nothing needs to move (a 1x1 mesh).

    A KV cache sharded over its sequence (decode): q's heads come whole on
    every device of that axis, so each scores its own rows of the cache
    (the softmax then gathers the scores, not the cache). Otherwise, where
    the rules split the query heads but not the kv heads (8 kv heads on a
    16-way axis), DTensor cannot split q's sharded heads into (kv head,
    group): each kv head is repeated over its group of query heads and
    sharded like q (a local slice of the replicated k/v, no traffic)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(q):
        return q, k, v
    if 1 in split_dims(k):
        return constrain(q, ("batch", None, None, None)), k, v
    H, K = q.shape[2], k.shape[2]
    if (not _heads_split("act_heads", H, mesh)
            or _heads_split("act_kv_heads", K, mesh)):
        return q, k, v

    def per_head(t):
        B, S, _, d = t.shape
        t = t[:, :, :, None, :].expand(B, S, K, H // K, d).reshape(B, S, H, d)
        return constrain(t, ("batch", None, "act_heads", None))
    return q, per_head(k), per_head(v)


def _per_shard(fn, q, k, v, mask=None, **kw):
    """`fn(q, k, v[, mask=mask], **kw)` on each device's own shards:
    attention is independent across batch rows and heads, so once k and v
    are laid out as q (split over those dims only) each device attends over
    its own rows and heads, and the result is laid out as q. A DTensor mask
    (B, ...) follows q's batch split. DTensor would otherwise plan every op
    of the core anew, and its bmm flattens two split dims into a strided
    one. (``local_map`` does the same; its placement arguments differ
    between PyTorch releases.)"""
    from torch.distributed.tensor import DTensor, Replicate

    mesh, pl = q.device_mesh, tuple(q.placements)
    if any(p.is_partial() or (p.is_shard() and p.dim not in (0, 2))
           for p in pl):
        raise ValueError(f"attention over a split sequence or head dim: {pl}")
    k, v = (t.redistribute(mesh, pl).to_local() for t in (k, v))
    if mask is not None:
        kw["mask"] = (mask.redistribute(mesh, [
            p if p.is_shard(0) else Replicate() for p in pl]).to_local()
            if is_dtensor(mask) else mask)
    out = fn(q.to_local(), k, v, **kw)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _attend(q, k, v, *, mask, softcap: Optional[float], scale: float):
    """q: (B,T,H,hd) k/v: (B,S,K,hd); grouped-query attention core."""
    q, k, v = _heads_for_mesh(q, k, v)
    if is_dtensor(q) and 1 not in split_dims(k):
        return _per_shard(_attend, q, k, v, mask=mask, softcap=softcap,
                          scale=scale)
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
    is O(T * kv_block) per head, never (T, S). Without autograd (serving)
    the block's logits are updated in place, which rounds as the
    out-of-place ops do; when a gradient is to flow (training) the same ops
    run out of place, so autograd keeps the tensors its backward reads."""
    q, k, v = _heads_for_mesh(q, k, v)
    if is_dtensor(q):
        return _per_shard(_attend_chunked, q, k, v, softcap=softcap,
                          scale=scale, window=window, kv_block=kv_block)
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
    inplace = not (torch.is_grad_enabled()
                   and (q.requires_grad or k.requires_grad or v.requires_grad))
    for off in range(0, nb * kv_block, kv_block):
        kc, vc = k[:, off:off + kv_block], v[:, off:off + kv_block]
        logits = torch.einsum("btkgh,bskh->bkgts", qg, kc).float()
        logits = logits.mul_(scale) if inplace else logits * scale
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        jk = off + torch.arange(kv_block, device=q.device)[None, :]
        msk = (jk <= iq) & (jk < S)
        if window is not None:
            msk &= jk > iq - window
        if inplace:
            logits.masked_fill_(~msk, NEG_INF)
        else:
            logits = logits.masked_fill(~msk, NEG_INF)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - new_m)
        if inplace:
            p = logits.sub_(new_m[..., None]).exp_()
        else:
            p = torch.exp(logits - new_m[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgts,bskh->bkgth", p,
                                                   vc.float())
        m = new_m
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, vd).to(v.dtype)


def pad_zeros(t, n: int, dim: int = 1):
    """`t` with `n` zero rows appended along `dim`, by a cat with zeros
    (the values of ``F.pad``): PyTorch 2.11's DTensor gives
    ``constant_pad_nd``'s result one placement per tensor dim, not one per
    mesh dim, and the next op on it fails."""
    shape = list(t.shape)
    shape[dim] = n
    return torch.cat([t, torch.zeros(shape, dtype=t.dtype, device=t.device)],
                     dim=dim)


def roll_rows(t, shift: int):
    """``torch.roll(t, shift, dims=1)`` as a cat of its two slices (the
    same values): PyTorch 2.11's DTensor has no strategy for roll."""
    cut = t.shape[1] - shift % t.shape[1]
    return torch.cat([t[:, cut:], t[:, :cut]], dim=1)


def write_rows(cache, write, new) -> None:
    """cache[b, write[b]] = new[b] for every slot b, in place (cache:
    (B, S, ...), write: (B,) int64, new: (B, ...)). A DTensor cache (under
    a mesh, its sequence sharded) has no indexed in-place write that keeps
    its layout: the rows are selected into a copy of the same values and
    copied back."""
    new = new.to(cache.dtype)
    if not is_dtensor(cache):
        cache[torch.arange(cache.shape[0], device=cache.device), write] = new
        return
    hit = (torch.arange(cache.shape[1], device=cache.device)[None, :]
           == write[:, None])
    hit = hit.reshape(*hit.shape, *([1] * (cache.dim() - 2)))
    cache.copy_(torch.where(hit, new[:, None], cache))


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
    kind="train": causal attention over the sequence, no cache (new_cache
    None), as prefill computes it.
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
    q = _project(x, p["wq"], "act_heads")
    k = _project(x, p["wk"], "act_kv_heads")
    v = _project(x, p["wv"], "act_kv_heads")
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = constrain(q, ("batch", None, "act_heads", None))
    k = constrain(k, ("batch", None, "act_kv_heads", None))
    v = constrain(v, ("batch", None, "act_kv_heads", None))
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
        write = idx.long() % S
        write_rows(kc, write, k[:, 0])
        write_rows(vc, write, v[:, 0])
        jk = torch.arange(S, device=x.device)[None, :]
        mask = jk <= idx.long()[:, None]
        if cfg.paged_kv and window is not None and S > window:
            mask = mask & (jk > idx.long()[:, None] - window)
        out = _attend(q, kc, vc, mask=mask[:, None, None, None, :],
                      softcap=cfg.attn_softcap, scale=scale)
        new_cache = {"k": kc, "v": vc, "idx": idx + 1}
    elif kind in ("prefill", "train"):
        if T > 2 * KV_BLOCK:
            out = _attend_chunked(q, k, v, softcap=cfg.attn_softcap,
                                  scale=scale, window=window)
        else:
            mask = _causal_mask(T, T, window=window, device=x.device)
            out = _attend(q, k, v, mask=mask, softcap=cfg.attn_softcap,
                          scale=scale)
        if kind == "train":
            return torch.einsum("bthk,hkd->btd", out, p["wo"]), None
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
            kc = roll_rows(k[:, T - target:], o)
            vc = roll_rows(v[:, T - target:], o)
        elif T < target:
            kc = pad_zeros(k, target - T)
            vc = pad_zeros(v, target - T)
        new_cache = {"k": kc.to(torch.bfloat16), "v": vc.to(torch.bfloat16),
                     "idx": torch.full((B,), T, dtype=torch.int32,
                                       device=x.device)}
    else:
        raise NotImplementedError(f"attention kind {kind!r} is not ported")
    y = torch.einsum("bthk,hkd->btd", out, p["wo"])
    return y, new_cache


def attention_cache_logical():
    """Logical axes of an attention layer's decode-cache leaves."""
    kv = ("cache_batch", "cache_seq", "act_kv_heads", "head_dim")
    return {"k": kv, "v": kv, "idx": ("cache_batch",)}


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


class _SumLookup(torch.autograd.Function):
    """The rows of a vocab-split table's lookup summed over the devices
    (DTensor's masked partial made replicated); the gradient goes back
    replicated, which the lookup's backward takes (DTensor cannot turn a
    gradient back into a masked partial)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        placements = [Replicate() if p.is_partial() else p
                      for p in x.placements]
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def embed_apply(p, tokens, *, cfg: ModelConfig):
    # a table split over its vocab rows (under a mesh) is looked up by
    # embedding, which DTensor runs as a masked local lookup and a sum;
    # indexing would gather the whole table
    if 0 in split_dims(p["table"]):
        # the d_model dim gathered first (FSDP), so the batch stays split
        table = constrain(p["table"], ("vocab", None))
        x = _SumLookup.apply(F.embedding(tokens, table))
    else:
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
    logits = constrain(logits, ("batch", None, "vocab"))
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits[..., :cfg.vocab_size]


def _xent_chunk(m, lse, tgt_logit, x, wc, targets, off: int, *,
                cfg: ModelConfig):
    """One vocab tile of `chunked_xent`: the tile's fp32 logits (softcap,
    then the padded rows masked), the online logsumexp update, and the
    target logit where the target falls in the tile."""
    C = wc.shape[0]
    logits = torch.einsum("bsd,cd->bsc", x, wc).float()
    logits = constrain(logits, ("batch", None, "vocab"))
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    valid = (off + torch.arange(C, device=x.device)) < cfg.vocab_size
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    # under a mesh each reduction over the split vocab is pinned whole over
    # its axis at once (DTensor would otherwise reduce-scatter it over the
    # sequence, and every later op, and the backward, would move it back)
    row = ("batch", None)
    new_m = torch.maximum(m, constrain(logits.amax(dim=-1), row))
    lse = torch.exp(m - new_m) * lse + constrain(torch.exp(
        logits - new_m[..., None]).sum(dim=-1), row)
    loc = targets.long() - off
    in_chunk = (loc >= 0) & (loc < C)
    if 2 in split_dims(logits):
        # vocab split over devices (a mesh): the target's logit is picked
        # by a mask and a sum over the tile, which stays split (a gather's
        # backward would gather the tile); the sum of one logit and zeros
        # is that logit
        hit = loc[..., None] == torch.arange(C, device=x.device)
        gathered = constrain(torch.where(
            hit, logits, torch.zeros_like(logits)).sum(-1), row)
    else:
        gathered = logits.gather(-1, loc.clamp(0, C - 1)[..., None])[..., 0]
    return new_m, lse, torch.where(in_chunk, gathered, tgt_logit)


def chunked_xent(p, x, targets, mask, *, cfg: ModelConfig):
    """Streaming cross-entropy over vocab tiles (reference ``chunked_xent``).

    Never materializes the (B, S, V) logits: a loop over the padded table's
    cfg.vocab_chunk tiles keeps an online logsumexp and picks the target
    logit on the fly. Each tile runs under ``torch.utils.checkpoint``, so
    its logits are recomputed in the backward (the reference's
    ``jax.checkpoint``) and only the (B, S) carries are kept.
    x: (B, S, D) final hiddens; targets: (B, S) int; mask: (B, S) {0, 1}.
    Returns the mean nll over the masked tokens (fp32)."""
    w = p["table"] if cfg.tie_embeddings else p["lm_head"]
    Vp = w.shape[0]
    C = min(cfg.vocab_chunk, Vp)
    # split, not a slice per tile: its backward writes the table's
    # gradient once, not one table-sized tensor per tile. Under a mesh the
    # vocab rows are gathered before the cut (DTensor cannot cut a split
    # dim), then each tile's rows split again (the reference's pin)
    tiles = [constrain(wc, ("vocab", "embed"))
             for wc in constrain(w, (None, "embed")).split(C)]
    B, S, _ = x.shape
    m = torch.full((B, S), NEG_INF, dtype=torch.float32, device=x.device)
    lse = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    tgt_logit = torch.full_like(m, NEG_INF)
    for i, wc in enumerate(tiles):
        m, lse, tgt_logit = checkpoint(
            _xent_chunk, m, lse, tgt_logit, x, wc, targets, i * C, cfg=cfg,
            use_reentrant=False, preserve_rng_state=False)
    nll = (m + torch.log(lse)) - tgt_logit
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
