"""Attention-free mixers of the port (``repro/models/ssm.py``): RWKV6 (Finch)
and Mamba2 (SSD).

Both come in two mathematically identical forms, as in the reference:
  * chunked (prefill): a loop over chunks of ``cfg.chunk_size`` carrying the
    state, with dense intra-chunk math (the reference's ``lax.scan``); every
    decay exponent of the factorization is <= 0, so nothing overflows;
  * recurrent (decode, and the oracle of the chunked form): one step at a
    time, O(1) state.

RWKV6 recurrence (per head, key dim N, value dim N; per-channel decay):
    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T ,   w_t = exp(-exp(w0 + lora(x_t)))
Mamba2 / SSD (per head, scalar decay a_t = exp(A * dt_t)):
    h_t = a_t h_{t-1} + (dt_t x_t) B_t^T ;  y_t = C_t . h_t + D x_t

The reference's rounding points are kept: the projections are bf16
products; r, k, v and the decay go to fp32 after them and the WKV state S
is fp32; the token-shift carries ``x_tm`` and ``x_cm`` stay in the
activations' type; Mamba's ``h`` is fp32 and its conv state is stored in
bf16; the depthwise conv sums its K bf16 products in bf16, tap by tap. The
group norm's variance is the population one, and softplus is the
reference's ``logaddexp(x, 0)`` (no switch to x above a threshold). All of
it is plain torch: in the reference these are jnp, not Pallas kernels.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import pad_zeros, rms_norm, rms_norm_params
from repro_torch.models.module import Param
from repro_torch.runtime.sharding import is_dtensor, split_dims

F32 = torch.float32


def _shift(x, x_prev):
    """Token shift: x_{t-1} along seq, slot 0 filled from the (B, D) carry
    x_prev (zeros at the sequence's start)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _lerp(x, x_shift, mu):
    return x + (x_shift - x) * mu


def _pad_seq(t, pad: int):
    """Zero rows appended along axis 1 (identity steps of a scan)."""
    return pad_zeros(t, pad)


class _ShardCumsum(torch.autograd.Function):
    """``torch.cumsum(x, 1)`` of a DTensor whose dim 1 is whole on every
    device, with autograd's own backward for cumsum (the gradient flipped,
    summed and flipped back) run on each device's shard: PyTorch 2.11's
    DTensor has no strategy for flip."""

    @staticmethod
    def forward(ctx, x):
        if 1 in split_dims(x):
            raise ValueError("cumsum over a dim split over devices")
        return torch.cumsum(x, dim=1)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        local = g.to_local().flip(1).cumsum(1).flip(1)
        return DTensor.from_local(local, g.device_mesh, g.placements,
                                  run_check=False)


def _cumsum_rows(x):
    """``torch.cumsum(x, dim=1)`` (a chunk's running sum over its steps);
    a DTensor's through :class:`_ShardCumsum`."""
    return _ShardCumsum.apply(x) if is_dtensor(x) else torch.cumsum(x, dim=1)


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear branch."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ==========================================================================
# RWKV6
# ==========================================================================
def rwkv_params(cfg: ModelConfig) -> Dict[str, Any]:
    D = cfg.d_model
    H, N = cfg.ssm_heads, cfg.ssm_head_dim
    dt = torch.bfloat16
    return {
        "norm_t": rms_norm_params(D),
        "norm_c": rms_norm_params(D),
        # time-mix
        "mu_r": Param((D,), ("embed",), F32, "normal", 0.2),
        "mu_k": Param((D,), ("embed",), F32, "normal", 0.2),
        "mu_v": Param((D,), ("embed",), F32, "normal", 0.2),
        "mu_w": Param((D,), ("embed",), F32, "normal", 0.2),
        "mu_g": Param((D,), ("embed",), F32, "normal", 0.2),
        "wr": Param((D, H * N), ("embed", "dinner"), dt, "fan_in"),
        "wk": Param((D, H * N), ("embed", "dinner"), dt, "fan_in"),
        "wv": Param((D, H * N), ("embed", "dinner"), dt, "fan_in"),
        "wg": Param((D, H * N), ("embed", "dinner"), dt, "fan_in"),
        "w0": Param((H, N), ("state", "head_dim"), F32, "normal", 0.5),
        "wd_a": Param((D, 64), ("embed", "lora"), dt, "fan_in"),
        "wd_b": Param((64, H * N), ("lora", "dinner"), dt, "fan_in"),
        "u": Param((H, N), ("state", "head_dim"), F32, "normal", 0.5),
        "ln_scale": Param((H, N), ("state", "head_dim"), F32, "zeros"),
        "ln_bias": Param((H, N), ("state", "head_dim"), F32, "zeros"),
        "wo": Param((H * N, D), ("dinner", "embed"), dt, "fan_in"),
        # channel-mix
        "cmu_k": Param((D,), ("embed",), F32, "normal", 0.2),
        "cmu_r": Param((D,), ("embed",), F32, "normal", 0.2),
        "cw_k": Param((D, cfg.d_ff), ("embed", "ff"), dt, "fan_in"),
        "cw_v": Param((cfg.d_ff, D), ("ff", "embed"), dt, "fan_in"),
        "cw_r": Param((D, D), ("embed", "act_embed"), dt, "fan_in"),
    }


def _rwkv_chunk(r, k, v, logw, u, S0):
    """One chunk, all heads. r, k, v, logw: (B, C, H, N) fp32; u: (H, N);
    S0: (B, H, N, N). Returns (out (B, C, H, N), S_C)."""
    C = r.shape[1]
    L = _cumsum_rows(logw)                              # L_t, t = 1..C (<= 0)
    L_prev = L - logw                                   # L_{t-1}
    # intra-chunk, strictly causal: decay exp(L_{t-1} - L_j) for j <= t-1
    dec = L_prev[:, :, None] - L[:, None, :]            # (B, C, C, H, N): t, j
    ar = torch.arange(C, device=r.device)
    tri = (ar[:, None] > ar[None, :])[None, :, :, None, None]
    dec = torch.where(tri, dec, torch.full((), float("-inf"), device=r.device))
    scores = torch.einsum("bthn,bjhn,btjhn->bhtj", r, k, torch.exp(dec))
    diag = torch.einsum("bthn,hn,bthn->bth", r, u, k)   # u-bonus at j = t
    out = torch.einsum("bhtj,bjhn->bthn", scores, v)
    out = out + diag[..., None] * v
    # inter-chunk: r_t decayed to the chunk's start, applied to S0
    out = out + torch.einsum("bthn,bhnm->bthm", r * torch.exp(L_prev), S0)
    # S_C = diag(exp(L_C)) S0 + sum_j (k_j exp(L_C - L_j)) v_j
    k_dec = k * torch.exp(L[:, -1:] - L)
    S = torch.exp(L[:, -1])[..., None] * S0 + torch.einsum(
        "bjhn,bjhm->bhnm", k_dec, v)
    return out, S


def rwkv_wkv_chunked(r, k, v, logw, u, S0, chunk: int):
    """(B, S, H, N) inputs -> (out (B, S, H, N), S_final): the exact chunked
    scan, a loop over chunks carrying S. A length that is not a multiple of
    the chunk is padded with identity steps (k = 0, logw = 0: the state is
    untouched) and sliced back."""
    S = r.shape[1]
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        r, k, v, logw = (_pad_seq(t, pad) for t in (r, k, v, logw))
    outs = []
    Sc = S0
    for lo in range(0, S + pad, C):
        o, Sc = _rwkv_chunk(r[:, lo:lo + C], k[:, lo:lo + C], v[:, lo:lo + C],
                            logw[:, lo:lo + C], u, Sc)
        outs.append(o)
    return torch.cat(outs, dim=1)[:, :S], Sc


def rwkv_wkv_recurrent(r, k, v, logw, u, S0):
    """The step-by-step form (the decode path when S == 1, and the chunked
    form's oracle)."""
    S = S0
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], logw[:, t]   # (B, H, N)
        out = torch.einsum("bhn,bhnm->bhm", rt, S) + torch.einsum(
            "bhn,hn,bhn,bhm->bhm", rt, u, kt, vt)
        S = torch.exp(wt)[..., None] * S + torch.einsum("bhn,bhm->bhnm",
                                                        kt, vt)
        outs.append(out)
    return torch.stack(outs, dim=1), S


def group_norm(out, scale, bias):
    """The per-head group norm of the time-mix output (fp32, population
    variance, eps 64e-5), then (1 + scale) and the bias."""
    mean = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, keepdim=True, correction=0)
    out = (out - mean) * torch.rsqrt(var + 64e-5)
    return out * (1.0 + scale) + bias


def _rwkv_time_mix(p, x, *, cfg: ModelConfig, state, kind: str):
    B, S, D = x.shape
    H, N = cfg.ssm_heads, cfg.ssm_head_dim
    x_prev = state["x_tm"] if state is not None else x.new_zeros((B, D))
    xs = _shift(x, x_prev.to(x.dtype))
    xr = _lerp(x, xs, p["mu_r"].to(x.dtype))
    xk = _lerp(x, xs, p["mu_k"].to(x.dtype))
    xv = _lerp(x, xs, p["mu_v"].to(x.dtype))
    xw = _lerp(x, xs, p["mu_w"].to(x.dtype))
    xg = _lerp(x, xs, p["mu_g"].to(x.dtype))
    r = (xr @ p["wr"]).reshape(B, S, H, N).float()
    k = (xk @ p["wk"]).reshape(B, S, H, N).float()
    v = (xv @ p["wv"]).reshape(B, S, H, N).float()
    g = F.silu(xg @ p["wg"]).reshape(B, S, H, N)
    dd = (torch.tanh(xw @ p["wd_a"]) @ p["wd_b"]).reshape(B, S, H, N).float()
    logw = -torch.exp(p["w0"][None, None] + dd)          # < 0
    S0 = (state["S"] if state is not None
          else torch.zeros((B, H, N, N), dtype=F32, device=x.device))
    if kind == "decode":
        out, S_new = rwkv_wkv_recurrent(r, k, v, logw, p["u"], S0)
    else:
        out, S_new = rwkv_wkv_chunked(r, k, v, logw, p["u"], S0,
                                      cfg.chunk_size)
    out = group_norm(out, p["ln_scale"], p["ln_bias"])
    y = (out.to(x.dtype) * g).reshape(B, S, H * N) @ p["wo"]
    new_state = None
    if kind in ("decode", "prefill"):
        new_state = {"S": S_new, "x_tm": x[:, -1, :]}
    return y, new_state


def _rwkv_channel_mix(p, x, *, cfg: ModelConfig, state, kind: str):
    B, S, D = x.shape
    x_prev = state["x_cm"] if state is not None else x.new_zeros((B, D))
    xs = _shift(x, x_prev.to(x.dtype))
    xk = _lerp(x, xs, p["cmu_k"].to(x.dtype))
    xr = _lerp(x, xs, p["cmu_r"].to(x.dtype))
    kk = torch.square(torch.relu(xk @ p["cw_k"]))
    y = torch.sigmoid(xr @ p["cw_r"]) * (kk @ p["cw_v"])
    new_state = ({"x_cm": x[:, -1, :]} if kind in ("decode", "prefill")
                 else None)
    return y, new_state


def rwkv_block_apply(p, x, *, cfg: ModelConfig, kind: str,
                     state: Optional[Dict[str, Any]] = None):
    """The whole RWKV block: time-mix and channel-mix sublayers, each with
    its own norm. Returns (x, new state {"S", "x_tm", "x_cm"} or None)."""
    tm_state = None if state is None else {"S": state["S"],
                                           "x_tm": state["x_tm"]}
    h, tm_new = _rwkv_time_mix(p, rms_norm(x, p["norm_t"], cfg.norm_eps),
                               cfg=cfg, state=tm_state, kind=kind)
    x = x + h
    cm_state = None if state is None else {"x_cm": state["x_cm"]}
    h, cm_new = _rwkv_channel_mix(p, rms_norm(x, p["norm_c"], cfg.norm_eps),
                                  cfg=cfg, state=cm_state, kind=kind)
    x = x + h
    new_state = None
    if kind in ("decode", "prefill"):
        new_state = {**tm_new, **cm_new}
    return x, new_state


def rwkv_state_spec(cfg: ModelConfig, batch: int):
    """(shape, dtype) of each state leaf: S fp32, the token-shift carries
    bf16."""
    H, N, D = cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_model
    return {"S": ((batch, H, N, N), F32),
            "x_tm": ((batch, D), torch.bfloat16),
            "x_cm": ((batch, D), torch.bfloat16)}


def rwkv_state_logical():
    return {"S": ("cache_batch", "act_heads", None, None),
            "x_tm": ("cache_batch", None),
            "x_cm": ("cache_batch", None)}


# ==========================================================================
# Mamba2 (SSD)
# ==========================================================================
def mamba_params(cfg: ModelConfig) -> Dict[str, Any]:
    D, din = cfg.d_model, cfg.d_inner
    H, N = cfg.ssm_heads, cfg.ssm_state
    K = cfg.conv_kernel
    dt = torch.bfloat16
    conv_ch = din + 2 * N
    return {
        "norm": rms_norm_params(D),
        "in_proj": Param((D, 2 * din + 2 * N + H), ("embed", "dinner"), dt,
                         "fan_in"),
        "conv_w": Param((K, conv_ch), ("conv", "dinner"), dt, "normal", 0.2),
        "conv_b": Param((conv_ch,), ("dinner",), dt, "zeros"),
        "A_log": Param((H,), ("state",), F32, "normal", 0.5),
        "D_skip": Param((H,), ("state",), F32, "ones"),
        "dt_bias": Param((H,), ("state",), F32, "zeros"),
        "gn_scale": Param((din,), ("dinner",), F32, "zeros"),
        "out_proj": Param((din, D), ("dinner", "embed"), dt, "fan_in"),
    }


def _ssd_chunk(x, B_, C_, la, dt_, S0):
    """x: (B, C, H, P) inputs; B_, C_: (B, C, N); la: (B, C, H) log decay;
    dt_: (B, C, H); S0: (B, H, P, N). h is read after its update (j <= t)."""
    C = x.shape[1]
    L = _cumsum_rows(la)                                 # (B, C, H), <= 0
    dec = L[:, :, None, :] - L[:, None, :, :]            # (B, t, j, H)
    ar = torch.arange(C, device=x.device)
    tri = (ar[:, None] >= ar[None, :])[None, :, :, None]
    dec = torch.where(tri, dec, torch.full((), float("-inf"), device=x.device))
    cb = torch.einsum("btn,bjn->btj", C_, B_)
    scores = cb[..., None] * torch.exp(dec)              # (B, t, j, H)
    out = torch.einsum("btjh,bjh,bjhp->bthp", scores, dt_, x)
    out = out + torch.einsum("btn,bth,bhpn->bthp", C_, torch.exp(L), S0)
    k_dec = dt_ * torch.exp(L[:, -1:, :] - L)            # (B, j, H)
    S = torch.exp(L[:, -1])[..., None, None] * S0 + torch.einsum(
        "bjh,bjhp,bjn->bhpn", k_dec, x, B_)
    return out, S


def mamba_ssd_chunked(x, B_, C_, la, dt_, S0, chunk: int):
    """The exact chunked SSD scan, a loop over chunks carrying h; a length
    that is not a multiple of the chunk is padded with identity steps
    (dt = 0, la = 0)."""
    S = x.shape[1]
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        x, B_, C_, la, dt_ = (_pad_seq(t, pad) for t in (x, B_, C_, la, dt_))
    outs = []
    Sc = S0
    for lo in range(0, S + pad, C):
        sl = slice(lo, lo + C)
        o, Sc = _ssd_chunk(x[:, sl], B_[:, sl], C_[:, sl], la[:, sl],
                           dt_[:, sl], Sc)
        outs.append(o)
    return torch.cat(outs, dim=1)[:, :S], Sc


def mamba_ssd_recurrent(x, B_, C_, la, dt_, S0):
    S = S0
    outs = []
    for t in range(x.shape[1]):
        xt, bt, ct, lat, dtt = x[:, t], B_[:, t], C_[:, t], la[:, t], dt_[:, t]
        S = torch.exp(lat)[..., None, None] * S + torch.einsum(
            "bh,bhp,bn->bhpn", dtt, xt, bt)
        outs.append(torch.einsum("bn,bhpn->bhp", ct, S))
    return torch.stack(outs, dim=1), S


def _depthwise_conv(xbc, w, b, conv_state):
    """Causal depthwise conv1d of kernel K. xbc: (B, S, Ch); w: (K, Ch);
    conv_state: (B, K - 1, Ch), the trailing context (zeros at the start).
    The K products summed one after another in xbc's type, as the
    reference's Python ``sum``. Returns (silu(out + b), new conv state)."""
    K = w.shape[0]
    full = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    T = full.shape[1]
    out = full[:, 0:T - (K - 1)] * w[0]
    for i in range(1, K):
        out = out + full[:, i:T - (K - 1 - i)] * w[i]
    return F.silu(out + b), full[:, -(K - 1):, :]


def mamba_block_apply(p, x, *, cfg: ModelConfig, kind: str,
                      state: Optional[Dict[str, Any]] = None):
    """The Mamba2 block with its residual. Returns (x, new state {"h",
    "conv"} or None)."""
    B, S, D = x.shape
    din, H, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    P = din // H
    K = cfg.conv_kernel
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    zxbcdt = h @ p["in_proj"]
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:2 * din + 2 * N]
    dt_raw = zxbcdt[..., 2 * din + 2 * N:]
    conv_state = (state["conv"] if state is not None
                  else x.new_zeros((B, K - 1, din + 2 * N)))
    xbc, conv_new = _depthwise_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xin = xbc[..., :din].reshape(B, S, H, P).float()
    B_ = xbc[..., din:din + N].float()
    C_ = xbc[..., din + N:].float()
    dt_ = softplus(dt_raw.float() + p["dt_bias"])
    la = -torch.exp(p["A_log"])[None, None, :] * dt_     # log decay, < 0
    S0 = (state["h"] if state is not None
          else torch.zeros((B, H, P, N), dtype=F32, device=x.device))
    if kind == "decode":
        out, S_new = mamba_ssd_recurrent(xin, B_, C_, la, dt_, S0)
    else:
        out, S_new = mamba_ssd_chunked(xin, B_, C_, la, dt_, S0,
                                       cfg.chunk_size)
    out = out + p["D_skip"][None, None, :, None] * xin
    out = out.reshape(B, S, din).to(x.dtype) * F.silu(z)
    out = rms_norm(out, p["gn_scale"], cfg.norm_eps)
    y = out @ p["out_proj"]
    new_state = None
    if kind in ("decode", "prefill"):
        new_state = {"h": S_new, "conv": conv_new.to(torch.bfloat16)}
    return x + y, new_state


def mamba_state_spec(cfg: ModelConfig, batch: int):
    """(shape, dtype) of each state leaf: h fp32, the conv state bf16."""
    H, N = cfg.ssm_heads, cfg.ssm_state
    P = cfg.d_inner // H
    K = cfg.conv_kernel
    return {"h": ((batch, H, P, N), F32),
            "conv": ((batch, K - 1, cfg.d_inner + 2 * N), torch.bfloat16)}


def mamba_state_logical():
    return {"h": ("cache_batch", "act_heads", None, None),
            "conv": ("cache_batch", None, "dinner")}
