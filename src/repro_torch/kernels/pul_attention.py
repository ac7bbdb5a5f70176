"""Attention kernels of the port: the paged decode K1-K4 and the flash
attention K7.

Five kernels, CUDA C++ for Hopper, in three sources (see the note at the
head of each file):

  * :func:`pul_paged_sweep_decode_attention` (K1) replaces the reference's
    ``kernels/pul_attention.py::pul_paged_sweep_decode_attention``: one layer
    step of the single-sweep decode over the FULL per-layer planes, with the
    current token's K/V committed to (layer, frames[b], kv_h, offsets[b]) in
    the kernel's epilogue. The planes are torch tensors updated in place —
    the port's counterpart of the reference's input/output aliasing and
    buffer donation.
  * :func:`pul_paged_decode_attention` (K2) replaces
    ``pul_paged_decode_attention``: the same attention over one layer's page
    frames, with an optional current token and no commit.
    K1/K2: ``csrc/pul_paged_decode.cu``.
  * :func:`pul_paged_sweep_mla_decode_attention` (K3) and
    :func:`pul_paged_mla_decode_attention` (K4) are the absorbed-MLA twins
    (deepseek-v2) over compressed-KV planes ``(L, NF, P, kvr)`` and
    ``(L, NF, P, dr)``: ``csrc/pul_paged_mla_decode.cu``.
  * :func:`pul_attention` (K7) replaces ``pul_attention``: flash attention
    over a dense (B, K, S, hd) KV with GQA, end-aligned causal masking, a
    sliding window and a softcap, the entry point of ``ops.attention_op``:
    ``csrc/pul_dense_attention.cu``, which also holds the dense decode K6
    (``kernels.pul_decode``).

Beside each kernel is its plain PyTorch version (``*_ref``): fp32 math on
gathered pages plus an ``index_put_`` commit. A wrapper uses the plain
version only for tensors on the CPU (the CPU tests); for CUDA tensors it
launches its kernel or raises. ``LAUNCHES`` counts kernel launches per
kernel, so a run can show the main path went through them.

The in-kernel PUL ring is budgeted against Hopper's shared memory by
:func:`ring_plan`, :func:`mla_ring_plan`, :func:`attention_tc_plan` (K7 in
bf16, on the tensor cores) and :func:`attention_ring_plan` (K7 in f32)
(the counterparts of the reference's ``ring_scratch`` VMEM check).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.pul import IssueStrategy, PULConfig
from repro_torch.kernels._runtime import (  # noqa: F401 (re-exported)
    LAUNCHES,
    MAX_RING_DISTANCE,
    SMEM_LIMIT_BYTES,
    RingPlan,
    _check,
    _plan,
    _ptr,
    _raise_on,
    _stream,
    lib,
)

NEG_INF = -2.0e38
#: element types the dense attention kernels K6/K7 take
DENSE_DTYPES = (torch.float32, torch.bfloat16)
#: head dims the dense attention kernels K6/K7 are built for: every hd of the
#: reference's tests and of the model zoo
DENSE_HDS = (16, 32, 64, 112, 128, 256)
#: query rows of one block of K7's f32 body (the source's kRows) and of its
#: bf16 tensor-core body (kTcRows): flattened (position, head) pairs of one
#: kv head's G heads
Q_ROWS = 64
TC_ROWS = 128
#: query heads one K3/K4 block holds (the MLA source's kMaxHeads)
HEAD_BLOCK = 8


def ring_plan(cfg: PULConfig, *, G: int, P: int, hd: int,
              itemsize: int = 2) -> RingPlan:
    """K1/K2's ring: a slot holds one page's K and V slab; besides the ring
    the block keeps q and the fp32 accumulator (G, hd), the page's logits
    (G, P) and m/l/corr (G,) in shared memory."""
    aux = (2 * G * hd + G * P + 3 * G) * 4
    return _plan(cfg, aux, 2 * P * hd * itemsize,
                 f"a ({P}, {hd}) page slab pair")


def head_block(H: int) -> int:
    """Query heads per K3/K4 block: the largest divisor of H up to
    HEAD_BLOCK (8 at deepseek-v2's 128 heads)."""
    return math.gcd(H, HEAD_BLOCK)


def mla_ring_plan(cfg: PULConfig, *, H: int, P: int, kvr: int, dr: int,
                  itemsize: int = 2) -> RingPlan:
    """K3/K4's ring: a slot holds one page's (P, kvr) c_kv and (P, dr) k_rope
    slab; besides the ring a block of Hb = head_block(H) heads keeps q_abs
    and the fp32 accumulator (Hb, kvr), q_rope (Hb, dr), the page's logits
    (Hb, P) and m/l/corr (Hb,) in fp32. At deepseek-v2 width (Hb = 8, P = 16)
    10 slots of 18,432 B fit."""
    Hb = head_block(H)
    aux = (2 * Hb * kvr + Hb * dr + Hb * P + 3 * Hb) * 4
    return _plan(cfg, aux, P * (kvr + dr) * itemsize,
                 f"a ({P}, {kvr}) + ({P}, {dr}) page slab pair")


def kv_chunk_rows(itemsize: int) -> int:
    """Keys of one K6/K7 ring chunk (the source's Chunk::kBC): 64 bf16 or
    32 f32 rows, 16 KB of K at hd = 128."""
    return 64 if itemsize == 2 else 32


def kv_slot_bytes(hd: int, itemsize: int) -> int:
    """One K6/K7 ring slot: a chunk's K rows and V rows, each row padded by
    one 16-byte granule (34,816 B bf16, 33,792 B f32 at hd = 128)."""
    return 2 * kv_chunk_rows(itemsize) * (hd * itemsize + 16)


def attention_ring_plan(cfg: PULConfig, *, hd: int = 128,
                        itemsize: int = 2) -> RingPlan:
    """The ring of K7's f32 body: a slot holds one KV chunk
    (:func:`kv_slot_bytes`); besides the ring a block keeps its Q_ROWS
    query rows in fp32 and the chunk's (Q_ROWS, kv_chunk_rows)
    probabilities; the accumulator is in registers. At hd = 128 and the
    default d = 4 BATCH that is 5 slots (of the 8 PULConfig asks for),
    223,232 B at itemsize 2 and 209,920 B f32."""
    aux = (Q_ROWS * hd + Q_ROWS * kv_chunk_rows(itemsize)) * 4
    return _plan(cfg, aux, kv_slot_bytes(hd, itemsize),
                 f"a {kv_chunk_rows(itemsize)}-key K and V chunk")


def tc_chunk_rows(hd: int) -> int:
    """Keys of one ring chunk of K7's bf16 body (the source's TcChunk::kBC):
    64, or 32 at hd = 256, where the 16 x 256 fp32 O tile of a warp takes
    128 registers."""
    return 32 if hd == 256 else 64


def attention_tc_plan(cfg: PULConfig, *, hd: int) -> RingPlan:
    """The ring of K7's bf16 tensor-core body: a slot holds tc_chunk_rows(hd)
    keys of K and of V in bf16, each row padded by one 16-byte granule;
    beside the ring a block keeps its TC_ROWS query rows in bf16, padded
    alike. At hd = 128 and the default d = 4 BATCH that is 5 slots of
    34,816 B and 34,816 B of q, 208,896 B."""
    row = hd * 2 + 16
    return _plan(cfg, TC_ROWS * row, 2 * tc_chunk_rows(hd) * row,
                 f"a {tc_chunk_rows(hd)}-key bf16 K and V chunk")


def attention_body(dtype: torch.dtype) -> str:
    """The K7 body that runs on the card for `dtype`: "mma.sync" (tensor
    cores) for bf16, "fma" (CUDA cores) for f32."""
    return "mma.sync" if dtype == torch.bfloat16 else "fma"


# ---------------------------------------------------------------------- #
# plain versions
# ---------------------------------------------------------------------- #
def _cap(x: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    return softcap * torch.tanh(x / softcap) if softcap is not None else x


def stream_length(S: int, bs: int) -> int:
    """The TPU kernels' KV stream of S keys in whole blocks of bs' = min(bs,
    S): ceil(S / bs') bs' positions."""
    bs = min(bs, S)
    return -(-S // bs) * bs


def padded_stream(k: torch.Tensor, bs: int) -> tuple:
    """k (B, K, S, hd) zero-padded to the TPU kernels' stream
    (:func:`stream_length`). Returns (k padded, its length)."""
    s_pad = stream_length(k.shape[2], bs)
    return torch.nn.functional.pad(k, (0, 0, 0, s_pad - k.shape[2])), s_pad


def _stream_softmax(logits: torch.Tensor, vis: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The TPU kernels' softmax over a padded stream: hidden logits are
    NEG_INF (finite), so a row that sees nothing weighs every position of
    the stream by exp(0) = 1; l is clamped at 1e-30."""
    logits = torch.where(vis, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return (p @ v) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def attention_kernel_ref(q, k, v, *, bs: int = 128, causal: bool = True,
                         scale: Optional[float] = None,
                         softcap: Optional[float] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """Plain version of K7: what the reference's Pallas kernel computes, in
    fp32. q (B, H, T, hd); k, v (B, K, S, hd). Query t sits at position
    iq = t + S - T; key jk is visible when jk < S, jk <= iq (causal) and
    jk > iq - window (window, with or without causal). The stream is
    zero-padded to whole bs blocks; a row that sees no key gets the sum of
    the v rows over the padded length (:func:`_stream_softmax`)."""
    B, H, T, hd = q.shape
    K, S = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kp, s_pad = padded_stream(k.float(), bs)
    vp, _ = padded_stream(v.float(), bs)
    qf = q.float().reshape(B, K, G, T, hd)
    logits = _cap(torch.einsum("bkgtd,bksd->bkgts", qf, kp) * scale, softcap)
    iq = torch.arange(T, device=q.device)[:, None] + (S - T)
    jk = torch.arange(s_pad, device=q.device)[None, :]
    vis = jk < S
    if causal:
        vis = vis & (jk <= iq)
    if window is not None:
        vis = vis & (jk > iq - window)
    out = _stream_softmax(logits, vis, vp[:, :, None])
    return out.reshape(B, H, T, hd).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, page_tables, lengths, *,
                               scale: Optional[float] = None,
                               softcap: Optional[float] = None,
                               window: Optional[int] = None,
                               k_new=None, v_new=None) -> torch.Tensor:
    """Plain version of K2: fp32 attention over the gathered pages.

    q (B, H, hd); k_pages/v_pages (NP, K, P, hd); page_tables (B, n_pages);
    lengths (B,); k_new/v_new (B, K, hd) or None. Positions < lengths[b]
    (and > lengths[b] - window) are visible; the current token always is.
    With nothing visible the output is 0, as in the kernel."""
    B, H, hd = q.shape
    NP, K, P, _ = k_pages.shape
    n_pages = page_tables.shape[1]
    G = H // K
    S = n_pages * P
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    pt = page_tables.long()
    qf = q.float().reshape(B, K, G, hd)
    kd = k_pages[pt].permute(0, 2, 1, 3, 4).reshape(B, K, S, hd).float()
    vd = v_pages[pt].permute(0, 2, 1, 3, 4).reshape(B, K, S, hd).float()
    logits = _cap(torch.einsum("bkgd,bksd->bkgs", qf, kd) * scale, softcap)
    jk = torch.arange(S, device=q.device)[None, :]
    L = lengths.to(q.device).long()[:, None]
    vis = jk < L
    if window is not None:
        vis = vis & (jk > L - window)
    if k_new is not None:
        ln = _cap(torch.einsum("bkgd,bkd->bkg", qf, k_new.float()) * scale,
                  softcap)
        logits = torch.cat([logits, ln[..., None]], dim=-1)
        vis = torch.cat([vis, torch.ones_like(vis[:, :1])], dim=-1)
        vd = torch.cat([vd, v_new.float()[:, :, None]], dim=2)
    vis = vis[:, None, None, :]
    logits = torch.where(vis, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p, vd) / l.clamp_min(1e-30)
    return out.reshape(B, H, hd).to(q.dtype)


def paged_sweep_decode_attention_ref(q, k_planes, v_planes, layer: int,
                                     page_tables, lengths, k_new, v_new,
                                     frames, offsets, *,
                                     scale: Optional[float] = None,
                                     softcap: Optional[float] = None,
                                     window: Optional[int] = None
                                     ) -> torch.Tensor:
    """Plain version of K1: K2's attention over plane row `layer`, then the
    commit of k_new/v_new at (layer, frames[b], :, offsets[b]) in place."""
    out = paged_decode_attention_ref(
        q, k_planes[layer], v_planes[layer], page_tables, lengths,
        scale=scale, softcap=softcap, window=window, k_new=k_new, v_new=v_new)
    idx = (frames.long().to(k_planes.device), offsets.long().to(k_planes.device))
    # (NF, K, P, hd) -> (NF, P, K, hd) view: (frame, offset) picks a (K, hd) row
    k_planes[layer].permute(0, 2, 1, 3).index_put_(idx, k_new.to(k_planes.dtype))
    v_planes[layer].permute(0, 2, 1, 3).index_put_(idx, v_new.to(v_planes.dtype))
    return out


def paged_mla_decode_attention_ref(q_abs, q_rope, ckv_pages, kr_pages,
                                   page_tables, lengths, c_new, r_new, *,
                                   scale: float) -> torch.Tensor:
    """Plain version of K4: fp32 absorbed-MLA attention over the gathered
    pages.

    q_abs (B, H, kvr); q_rope (B, H, dr); ckv_pages (NP, P, kvr) and
    kr_pages (NP, P, dr); page_tables (B, n_pages); lengths (B,); c_new /
    r_new (B, kvr) / (B, dr), the current token, always visible (None only
    to plant the fault of a kernel that drops it; nothing visible then
    gives 0). Logits are (q_abs . c + q_rope . r) * scale over positions
    < lengths[b]; the compressed rows c are also the values. Returns
    (B, H, kvr)."""
    B, H, kvr = q_abs.shape
    P = ckv_pages.shape[1]
    dr = q_rope.shape[-1]
    S = page_tables.shape[1] * P
    pt = page_tables.long()
    cd = ckv_pages[pt].reshape(B, S, kvr).float()
    rd = kr_pages[pt].reshape(B, S, dr).float()
    jk = torch.arange(S, device=q_abs.device)[None, :]
    vis = jk < lengths.to(q_abs.device).long()[:, None]
    if c_new is not None:
        cd = torch.cat([cd, c_new.float()[:, None]], dim=1)     # (B, S+1, kvr)
        rd = torch.cat([rd, r_new.float()[:, None]], dim=1)
        vis = torch.cat([vis, torch.ones_like(vis[:, :1])], dim=1)
    logits = (torch.einsum("bhr,bsr->bhs", q_abs.float(), cd)
              + torch.einsum("bhd,bsd->bhs", q_rope.float(), rd)) * scale
    vis = vis[:, None, :]
    logits = torch.where(vis, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhs,bsr->bhr", p, cd) / l.clamp_min(1e-30)
    return out.to(q_abs.dtype)


def paged_sweep_mla_decode_attention_ref(q_abs, q_rope, ckv_planes, kr_planes,
                                         layer: int, page_tables, lengths,
                                         c_new, r_new, frames, offsets, *,
                                         scale: float) -> torch.Tensor:
    """Plain version of K3: K4's attention over plane row `layer`, then the
    commit of c_new/r_new at (layer, frames[b], offsets[b]) in place."""
    out = paged_mla_decode_attention_ref(
        q_abs, q_rope, ckv_planes[layer], kr_planes[layer], page_tables,
        lengths, c_new, r_new, scale=scale)
    idx = (frames.long().to(ckv_planes.device),
           offsets.long().to(ckv_planes.device))
    ckv_planes[layer].index_put_(idx, c_new.to(ckv_planes.dtype))
    kr_planes[layer].index_put_(idx, r_new.to(kr_planes.dtype))
    return out


# ---------------------------------------------------------------------- #
# kernel wrappers
# ---------------------------------------------------------------------- #
def _check_common(q, k, v, page_tables, lengths, k_new, v_new, plane_shape):
    if q.device.type != "cuda":
        raise ValueError(f"the paged decode kernels run on CUDA tensors, got "
                         f"{q.device}")
    B, H, hd = q.shape
    K, P = plane_shape[-3], plane_shape[-2]
    if H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    if (P * hd * 2) % 16:
        raise ValueError(f"a ({P}, {hd}) bf16 page slab is not a multiple of "
                         "the 16-byte cp.async granule")
    dev = q.device
    _check("q", q, (B, H, hd), torch.bfloat16, dev)
    _check("k planes", k, plane_shape, torch.bfloat16, dev)
    _check("v planes", v, plane_shape, torch.bfloat16, dev)
    _check("page_tables", page_tables, (B, page_tables.shape[1]), torch.int32,
           dev)
    _check("lengths", lengths, (B,), torch.int32, dev)
    if k_new is not None:
        _check("k_new", k_new, (B, K, hd), torch.bfloat16, dev)
        _check("v_new", v_new, (B, K, hd), torch.bfloat16, dev)


def pul_paged_decode_attention(q, k_pages, v_pages, page_tables, lengths, *,
                               cfg: PULConfig = PULConfig(),
                               scale: Optional[float] = None,
                               softcap: Optional[float] = None,
                               window: Optional[int] = None,
                               k_new=None, v_new=None) -> torch.Tensor:
    """K2: decode attention straight over one layer's page frames.

    q (B, H, hd); k_pages/v_pages (NP, K, P, hd); page_tables (B, n_pages)
    int32; lengths (B,) int32; k_new/v_new (B, K, hd), the current token,
    folded into the online softmax after the page stream. Returns (B, H, hd).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new/v_new come as a pair")
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pages, v_pages, page_tables, lengths, scale=scale,
            softcap=softcap, window=window, k_new=k_new, v_new=v_new)
    _check_common(q, k_pages, v_pages, page_tables, lengths, k_new, v_new,
                  k_pages.shape)
    B, H, hd = q.shape
    NP, K, P, _ = k_pages.shape
    plan = ring_plan(cfg, G=H // K, P=P, hd=hd)
    out = torch.empty_like(q)
    rc = lib("pul_paged_decode").pul_paged_decode(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(page_tables),
        _ptr(lengths), _ptr(k_new), _ptr(v_new), _ptr(out),
        B, K, H // K, P, hd, page_tables.shape[1], NP,
        scale if scale is not None else 1.0 / math.sqrt(hd),
        softcap if softcap is not None else 0.0,
        window if window is not None else 0,
        plan.distance, plan.slots,
        int(cfg.strategy is IssueStrategy.SEQUENTIAL), plan.smem_bytes,
        _stream(q))
    _raise_on(rc, "pul_paged_decode")
    LAUNCHES["k2"] += 1
    return out


def pul_paged_sweep_decode_attention(q, k_planes, v_planes, layer: int,
                                     page_tables, lengths, k_new, v_new,
                                     frames, offsets, *,
                                     cfg: PULConfig = PULConfig(),
                                     scale: Optional[float] = None,
                                     softcap: Optional[float] = None,
                                     window: Optional[int] = None
                                     ) -> torch.Tensor:
    """K1: one layer step of the single-sweep paged decode.

    q (B, H, hd); k_planes/v_planes (L, NF, K, P, hd), the ENTIRE per-layer
    store, never sliced on the host; layer: the plane row to read; k_new /
    v_new (B, K, hd), merged into the online softmax AND written to plane
    position (layer, frames[b], kv_h, offsets[b]); frames/offsets (B,) int32
    (the TRASH frame for inactive slots). Returns out (B, H, hd); the planes
    are updated in place."""
    if q.device.type == "cpu":
        return paged_sweep_decode_attention_ref(
            q, k_planes, v_planes, layer, page_tables, lengths, k_new, v_new,
            frames, offsets, scale=scale, softcap=softcap, window=window)
    _check_common(q, k_planes, v_planes, page_tables, lengths, k_new, v_new,
                  k_planes.shape)
    B, H, hd = q.shape
    L, NF, K, P, _ = k_planes.shape
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the planes' {L} layers")
    _check("frames", frames, (B,), torch.int32, q.device)
    _check("offsets", offsets, (B,), torch.int32, q.device)
    plan = ring_plan(cfg, G=H // K, P=P, hd=hd)
    out = torch.empty_like(q)
    rc = lib("pul_paged_decode").pul_paged_sweep_decode(
        _ptr(q), _ptr(k_planes), _ptr(v_planes), _ptr(page_tables),
        _ptr(lengths), _ptr(k_new), _ptr(v_new), _ptr(frames), _ptr(offsets),
        _ptr(out), B, K, H // K, P, hd, page_tables.shape[1], NF, int(layer),
        scale if scale is not None else 1.0 / math.sqrt(hd),
        softcap if softcap is not None else 0.0,
        window if window is not None else 0,
        plan.distance, plan.slots,
        int(cfg.strategy is IssueStrategy.SEQUENTIAL), plan.smem_bytes,
        _stream(q))
    _raise_on(rc, "pul_paged_sweep_decode")
    LAUNCHES["k1"] += 1
    return out


def _check_mla(q_abs, q_rope, ckv, kr, page_tables, lengths, c_new, r_new):
    if q_abs.device.type != "cuda":
        raise ValueError(f"the paged decode kernels run on CUDA tensors, got "
                         f"{q_abs.device}")
    B, H, kvr = q_abs.shape
    dr = q_rope.shape[-1]
    if kvr % 8 or dr % 8:
        raise ValueError(f"a bf16 row of {kvr} (c_kv) or {dr} (k_rope) values "
                         "is not a whole number of 16-byte cp.async granules")
    dev = q_abs.device
    _check("q_abs", q_abs, (B, H, kvr), torch.bfloat16, dev)
    _check("q_rope", q_rope, (B, H, dr), torch.bfloat16, dev)
    _check("c_kv planes", ckv, (*ckv.shape[:-1], kvr), torch.bfloat16, dev)
    _check("k_rope planes", kr, (*ckv.shape[:-1], dr), torch.bfloat16, dev)
    _check("page_tables", page_tables, (B, page_tables.shape[1]), torch.int32,
           dev)
    _check("lengths", lengths, (B,), torch.int32, dev)
    _check("c_new", c_new, (B, kvr), torch.bfloat16, dev)
    _check("r_new", r_new, (B, dr), torch.bfloat16, dev)


def pul_paged_mla_decode_attention(q_abs, q_rope, ckv_pages, kr_pages,
                                   page_tables, lengths, c_new, r_new, *,
                                   scale: float,
                                   cfg: PULConfig = PULConfig()) -> torch.Tensor:
    """K4: absorbed-MLA decode attention straight over one layer's
    compressed-KV page frames.

    q_abs (B, H, kvr): queries absorbed into the compressed space; q_rope
    (B, H, dr); ckv_pages (NP, P, kvr) and kr_pages (NP, P, dr); page_tables
    (B, n_pages) int32; lengths (B,) int32; c_new / r_new (B, kvr) / (B, dr),
    the current token, folded in after the page stream. Returns o_c
    (B, H, kvr); the caller applies the absorbed v up-projection. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if q_abs.device.type == "cpu":
        return paged_mla_decode_attention_ref(
            q_abs, q_rope, ckv_pages, kr_pages, page_tables, lengths, c_new,
            r_new, scale=scale)
    _check_mla(q_abs, q_rope, ckv_pages, kr_pages, page_tables, lengths,
               c_new, r_new)
    B, H, kvr = q_abs.shape
    NP, P, _ = ckv_pages.shape
    dr = q_rope.shape[-1]
    plan = mla_ring_plan(cfg, H=H, P=P, kvr=kvr, dr=dr)
    out = torch.empty_like(q_abs)
    rc = lib("pul_paged_mla_decode").pul_paged_mla_decode(
        _ptr(q_abs), _ptr(q_rope), _ptr(ckv_pages), _ptr(kr_pages),
        _ptr(page_tables), _ptr(lengths), _ptr(c_new), _ptr(r_new), _ptr(out),
        B, H, head_block(H), P, kvr, dr, page_tables.shape[1], NP, scale,
        plan.distance, plan.slots,
        int(cfg.strategy is IssueStrategy.SEQUENTIAL), plan.smem_bytes,
        _stream(q_abs))
    _raise_on(rc, "pul_paged_mla_decode")
    LAUNCHES["k4"] += 1
    return out


def pul_paged_sweep_mla_decode_attention(q_abs, q_rope, ckv_planes, kr_planes,
                                         layer: int, page_tables, lengths,
                                         c_new, r_new, frames, offsets, *,
                                         scale: float,
                                         cfg: PULConfig = PULConfig()
                                         ) -> torch.Tensor:
    """K3: absorbed-MLA layer step of the single-sweep paged decode.

    ckv_planes (L, NF, P, kvr), kr_planes (L, NF, P, dr): the ENTIRE
    per-layer compressed store; layer: the plane row to read; c_new / r_new
    (B, kvr) / (B, dr) are merged into the online softmax AND written to
    (layer, frames[b], offsets[b]); frames/offsets (B,) int32 (the TRASH
    frame for inactive slots). Returns o_c (B, H, kvr); the planes are
    updated in place."""
    if q_abs.device.type == "cpu":
        return paged_sweep_mla_decode_attention_ref(
            q_abs, q_rope, ckv_planes, kr_planes, layer, page_tables, lengths,
            c_new, r_new, frames, offsets, scale=scale)
    _check_mla(q_abs, q_rope, ckv_planes, kr_planes, page_tables, lengths,
               c_new, r_new)
    B, H, kvr = q_abs.shape
    L, NF, P, _ = ckv_planes.shape
    dr = q_rope.shape[-1]
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the planes' {L} layers")
    _check("frames", frames, (B,), torch.int32, q_abs.device)
    _check("offsets", offsets, (B,), torch.int32, q_abs.device)
    plan = mla_ring_plan(cfg, H=H, P=P, kvr=kvr, dr=dr)
    out = torch.empty_like(q_abs)
    rc = lib("pul_paged_mla_decode").pul_paged_sweep_mla_decode(
        _ptr(q_abs), _ptr(q_rope), _ptr(ckv_planes), _ptr(kr_planes),
        _ptr(page_tables), _ptr(lengths), _ptr(c_new), _ptr(r_new),
        _ptr(frames), _ptr(offsets), _ptr(out),
        B, H, head_block(H), P, kvr, dr, page_tables.shape[1], NF, int(layer),
        scale, plan.distance, plan.slots,
        int(cfg.strategy is IssueStrategy.SEQUENTIAL), plan.smem_bytes,
        _stream(q_abs))
    _raise_on(rc, "pul_paged_sweep_mla_decode")
    LAUNCHES["k3"] += 1
    return out


def _check_dense(q, k, v) -> None:
    """What K6 and K7 take on the card: hd in DENSE_HDS, f32 or bf16
    throughout, contiguous tensors on q's card. The head dim is checked
    first, so that tensors on no device (``meta``) show the shapes the
    kernels take."""
    B, K, S, hd = k.shape
    if hd not in DENSE_HDS:
        raise ValueError(f"head dim {hd}: the kernel is built for "
                         f"{DENSE_HDS}")
    if q.device.type != "cuda":
        raise ValueError(f"the dense attention kernels run on CUDA tensors, "
                         f"got {q.device}")
    if q.dtype not in DENSE_DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, the kernel takes "
                        f"{', '.join(map(str, DENSE_DTYPES))}")
    _check("q", q, q.shape, q.dtype, q.device)
    _check("k", k, (B, K, S, hd), q.dtype, q.device)
    _check("v", v, (B, K, S, hd), q.dtype, q.device)


def _dense_args(cfg: PULConfig, plan: RingPlan, q: torch.Tensor):
    """The ring's and the type's launch arguments, in the C order."""
    return (plan.distance, plan.slots,
            int(cfg.strategy is IssueStrategy.SEQUENTIAL),
            DENSE_DTYPES.index(q.dtype), plan.smem_bytes, _stream(q))


def _check_options(S: int, scale, softcap, window) -> None:
    if S < 1:
        raise ValueError("attention over an empty KV")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap {softcap} is not positive")
    if window is not None and window < 1:
        raise ValueError(f"window {window} is not positive")


def pul_attention(q, k, v, *, cfg: PULConfig = PULConfig(), bt: int = 128,
                  bs: int = 128, causal: bool = True,
                  scale: Optional[float] = None,
                  softcap: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """K7: flash attention of q (B, H, T, hd) over k, v (B, K, S, hd),
    H = K G, with the reference's signature (bt, bs: its query and KV block
    sizes; T % min(bt, T) == 0). Returns (B, H, T, hd) in q's type. CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    takes f32 or bf16, hd in DENSE_HDS and any G, and tiles by its own rule;
    bs keeps its meaning in the padded stream's length. The body follows the
    type (:func:`attention_body`): bf16 runs on the tensor cores
    (attention_tc_plan), f32 on the CUDA cores (attention_ring_plan)."""
    B, H, T, hd = q.shape
    _, K, S, _ = k.shape
    if H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    bt = min(bt, T)
    if T % bt:
        raise ValueError(f"{T} queries are not whole blocks of {bt}")
    _check_options(S, scale, softcap, window)
    if q.device.type == "cpu":
        return attention_kernel_ref(q, k, v, bs=bs, causal=causal,
                                    scale=scale, softcap=softcap,
                                    window=window)
    G = H // K
    _check_dense(q, k, v)
    s_pad = stream_length(S, bs)
    tc = attention_body(q.dtype) == "mma.sync"
    plan = (attention_tc_plan(cfg, hd=hd) if tc else
            attention_ring_plan(cfg, hd=hd, itemsize=q.element_size()))
    out = torch.empty_like(q)
    rc = lib("pul_dense_attention").pul_flash_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), B, K, G, T, S, hd, s_pad,
        int(causal), window or 0,
        scale if scale is not None else 1.0 / math.sqrt(hd),
        softcap or 0.0, *_dense_args(cfg, plan, q))
    _raise_on(rc, "pul_flash_attention")
    LAUNCHES["k7"] += 1
    LAUNCHES["k7_tc"] += tc
    return out
