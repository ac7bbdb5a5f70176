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
    K1/K2: ``csrc/pul_paged_decode.cu``, split-KV over the page table: a
    split kernel streams each row's visible pages in n_split parts, and a
    merge kernel folds the parts' softmax states with the current token
    (and, for K1, commits it).
  * :func:`pul_paged_sweep_mla_decode_attention` (K3) and
    :func:`pul_paged_mla_decode_attention` (K4) are the absorbed-MLA twins
    (deepseek-v2) over compressed-KV planes ``(L, NF, P, kvr)`` and
    ``(L, NF, P, dr)``: ``csrc/pul_paged_mla_decode.cu``, split-KV over the
    page table as K1/K2, with 64 heads a block and the logit and value
    products on the tensor cores (mma.sync).
  * :func:`pul_attention` (K7) replaces ``pul_attention``: flash attention
    over a dense (B, K, S, hd) KV with GQA, end-aligned causal masking, a
    sliding window and a softcap, the entry point of ``ops.attention_op``:
    ``csrc/pul_dense_attention.cu``, which also holds the dense decode K6
    (``kernels.pul_decode``).

Beside each kernel is its plain PyTorch version (``*_ref``): fp32 math on
gathered pages plus an ``index_put_`` commit. A wrapper uses the plain
version only for tensors on the CPU (the CPU tests); for CUDA tensors it
launches its kernel or raises. ``LAUNCHES`` counts kernel launches per
kernel, so a run can show the main path went through them (one per K1-K4
call, which launches a split and a merge kernel).
:func:`paged_decode_split_ref` and :func:`paged_mla_decode_split_ref` model
the split-and-merge arithmetic in plain PyTorch, for the tests and the
smoke's planted fault.

The in-kernel PUL ring is budgeted against Hopper's shared memory by
:func:`paged_split_plan` (which also picks K1/K2's split count),
:func:`mla_split_plan` (K3/K4's), :func:`attention_tc_plan` (K7 in bf16, on
the tensor cores) and :func:`attention_ring_plan` (K7 in f32) (the
counterparts of the reference's ``ring_scratch`` VMEM check).
"""
from __future__ import annotations

import dataclasses
import functools
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
#: query rows of one block of K7's f32 body (the source's F32Tile::kBR,
#: halved at hd 256: :func:`attention_f32_tiles`) and of its bf16
#: tensor-core body (kTcRows): flattened (position, head) pairs of one kv
#: head's G heads
Q_ROWS = 128
TC_ROWS = 128
#: the bodies of K7 (the ``body`` field of the smoke's rows)
TC_BODY, F32_BODY = "mma.sync", "fma-tiled"
#: query heads of one K3/K4 split block (the MLA source's kHeads): four m16
#: tiles; head rows past H are zero and never written out
MLA_HEADS = 64
#: most splits of a K3/K4 row (the source's kMaxSplits: the merge keeps a
#: weight per split and head in shared memory)
MLA_MAX_SPLITS = 256
#: widest c_kv row K3/K4 take (a warp's half of it is its fp32 accumulator:
#: 128 registers at 512)
MLA_MAX_KVR = 512
#: shared memory of a K3/K4 split block besides its ring and q tile: the
#: double-buffered exchange of the logits' partial sums (the source's
#: kXchgFloats)
MLA_XCHG_BYTES = 16384
#: the K3/K4 body that runs on the card (the ``body`` field of the smoke's
#: rows): split-KV with the products on the tensor cores
MLA_BODY = "split-kv mma.sync"


#: blocks per SM that K1/K2's split plan aims the grid at
SPLIT_BLOCKS_PER_SM = 4
#: query heads of one kv head K1/K2 hold (the source's kMaxG) and the
#: widest head (kMaxHd: a row over one warp's lanes, 16 bytes each)
PAGED_MAX_GROUP = 16
PAGED_MAX_HD = 256
#: warps of a K1/K2 split block (the source's kWarps), whose softmax states
#: meet in shared memory at the block's end
PAGED_WARPS = 4
#: the K1/K2 body that runs on the card (the ``body`` field of the smoke's
#: rows): split-KV on the CUDA cores
PAGED_BODY = "split-kv"


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    distance: int         # pages preloaded ahead of the compute
    slots: int            # ring slots, each one page's K and V slab
    smem_bytes: int       # dynamic shared memory of one split block
    n_split: int          # splits of each row's visible pages
    pages_per_split: int  # most pages one split streams


def paged_split_plan(cfg: PULConfig, *, B: int, K: int, G: int, P: int,
                     hd: int, n_pages: int, sms: int = 132,
                     n_split: Optional[int] = None) -> SplitPlan:
    """K1/K2's split count and ring. n_split (unless given) aims the
    (n_split, K, B) grid at SPLIT_BLOCKS_PER_SM blocks per SM, within
    [1, n_pages]: 8 at the smoke's B = 8, K = 8 on 132 SMs. It uses the
    shapes and the SM count only, never the layer, the planes' depth or the
    lengths, so K1 and K2 get one plan and no host sync. A ring slot holds
    one page's K and V slab; besides the ring a block keeps its warps'
    softmax states (m, l and the (G, hd) accumulator, fp32) for the merge at
    its end. The distance is clamped to the pages of a split
    (ceil(n_pages / n_split)), then distance and slots to shared memory and
    the wait table as for every ring."""
    if n_split is None:
        n_split = SPLIT_BLOCKS_PER_SM * sms // (B * K)
    n_split = max(1, min(n_pages, n_split))
    per = -(-n_pages // n_split)
    aux = PAGED_WARPS * G * (hd + 2) * 4
    ring = _plan(cfg.replace(distance=min(cfg.distance, per)), aux,
                 2 * P * hd * 2, f"a ({P}, {hd}) page slab pair")
    return SplitPlan(ring.distance, ring.slots, ring.smem_bytes, n_split, per)


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def mla_split_plan(cfg: PULConfig, *, B: int, H: int, P: int, kvr: int,
                   dr: int, n_pages: int, sms: int = 132,
                   n_split: Optional[int] = None) -> SplitPlan:
    """K3/K4's split count and ring. n_split (unless given) aims the
    (n_split, ceil(H / MLA_HEADS), B) grid at one block per SM, within [1,
    min(n_pages, MLA_MAX_SPLITS)]: 132 // (8 x 2) = 8 at the smoke's B = 8,
    H = 128. It uses the shapes and the SM count only, never the layer, the
    planes' depth or the lengths, so K3 and K4 get one plan and no host
    sync. A shared row holds one token's c | r features, F = kvr + dr
    rounded up to 16 (zeros past dr), plus one 16-byte pad granule; a ring
    slot holds one page's rows, P rounded up to 16 (zero rows past P), and
    its mbarrier (16 B reserved); besides the ring a block keeps its
    MLA_HEADS heads' q_abs | q_rope rows (zero rows past H), their mbarrier
    and the MLA_XCHG_BYTES exchange. At deepseek-v2 width a slot is 18,704
    B beside 91,152 B, so 7 fit. The distance is clamped to the pages of a
    split (ceil(n_pages / n_split)), then distance and slots to shared
    memory and the wait table as for every ring."""
    if n_split is None:
        n_split = sms // (B * -(-H // MLA_HEADS))
    n_split = max(1, min(n_pages, MLA_MAX_SPLITS, n_split))
    per = -(-n_pages // n_split)
    row = (kvr + _round16(dr)) * 2 + 16
    aux = MLA_HEADS * row + MLA_XCHG_BYTES + 16
    ring = _plan(cfg.replace(distance=min(cfg.distance, per)), aux,
                 _round16(P) * row + 16,
                 f"a ({P}, {kvr}) + ({P}, {dr}) page slab pair")
    return SplitPlan(ring.distance, ring.slots, ring.smem_bytes, n_split, per)


def kv_chunk_rows(itemsize: int) -> int:
    """Keys of one K6/K7 ring chunk (the source's Chunk::kBC): 64 bf16 or
    32 f32 rows, 16 KB of K at hd = 128."""
    return 64 if itemsize == 2 else 32


def kv_slot_bytes(hd: int, itemsize: int) -> int:
    """One K6/K7 ring slot: a chunk's K rows and V rows, each row padded by
    one 16-byte granule (34,816 B bf16, 33,792 B f32 at hd = 128)."""
    return 2 * kv_chunk_rows(itemsize) * (hd * itemsize + 16)


@dataclasses.dataclass(frozen=True)
class FlashTiles:
    rows: int           # query rows of a block
    s_thread: tuple     # (rows, keys) of S = Q K^T a lane holds
    s_warp: tuple       # (rows, keys) of S a warp holds
    o_thread: tuple     # (rows, dims) of O a lane holds
    o_threads: int      # threads of the block that hold an O tile


#: warps of a K7 f32 block (the source's kWarps), each owning an eighth of
#: its rows
F32_WARPS = 8


def attention_f32_tiles(hd: int) -> FlashTiles:
    """The register tiles of K7's f32 body at head dim hd (the source's
    F32Tile): Q_ROWS rows a block (Q_ROWS / 2 at hd 256), an eighth of them
    a warp (its S, softmax state and O); in S = Q K^T a lane holds
    rows / 32 x 4 of a chunk's kv_chunk_rows(4) = 32 keys, in O += P V a
    lane holds 8 x 8 (rows x dims) at hd >= 112, 8 x 4 at 64 and 4 x 4
    below. At hd 128: 128 rows, S 4 x 4 a lane and 16 x 32 a warp, O 8 x 8
    a lane on all 256 threads."""
    rows = Q_ROWS // 2 if hd == 256 else Q_ROWS
    keys, warp_rows = kv_chunk_rows(4), rows // F32_WARPS
    tdo = 8 if hd >= 112 else 4
    dg = hd // tdo
    rgw = min(32 // dg, warp_rows // 4)
    return FlashTiles(rows, (warp_rows // 4, keys // 8), (warp_rows, keys),
                      (warp_rows // rgw, tdo), F32_WARPS * rgw * dg)


def attention_ring_plan(cfg: PULConfig, *, hd: int = 128,
                        itemsize: int = 4) -> RingPlan:
    """The ring of K7's f32 body: a slot holds one KV chunk
    (:func:`kv_slot_bytes`); besides the ring a block keeps, in fp32, its
    query rows (:func:`attention_f32_tiles`) padded by a granule, each row's
    sum, and each warp's probabilities of a chunk, transposed (keys x its
    rows, padded by a granule), and its rows' rescale factors; the
    accumulator is in registers. At hd = 128 that is 89,088 B beside 4
    slots of 33,792 B f32, so the default d = 4 BATCH keeps 4 of the 8
    slots PULConfig asks for and SEQUENTIAL runs at d = 3."""
    rows = attention_f32_tiles(hd).rows
    keys, warp_rows = kv_chunk_rows(4), rows // F32_WARPS
    warp = keys * (warp_rows + 4) + warp_rows
    aux = (rows * (hd + 4) + rows + F32_WARPS * warp) * 4
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
    """The K7 body that runs on the card for `dtype`: TC_BODY (mma.sync,
    tensor cores) for bf16, F32_BODY (register-tiled fp32 FMAs, CUDA cores)
    for f32."""
    return TC_BODY if dtype == torch.bfloat16 else F32_BODY


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


def paged_decode_split_ref(q, k_pages, v_pages, page_tables, lengths, *,
                           n_split: int, scale: Optional[float] = None,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None, k_new=None,
                           v_new=None,
                           drop_split: Optional[int] = None) -> torch.Tensor:
    """The split-and-merge arithmetic of the K1/K2 kernels, in plain fp32
    PyTorch, for the tests and the smoke's planted fault (the wrappers take
    :func:`paged_decode_attention_ref` on the CPU). Shapes as K2.

    Row b's visible pages [lo, hi) (lo from the window's first position, hi
    = ceil(lengths[b] / P)) go to n_split splits of c = ceil((hi - lo) /
    n_split) pages; split s keeps (m, l, acc) over the visible keys of
    pages [lo + s c, min(hi, lo + (s + 1) c)), masked keys weighing 0, and
    an empty split m = NEG_INF, l = acc = 0. The merge takes M = max(m_s,
    logit_new) and gives (sum acc_s e^(m_s - M) + p_new v_new) / max(sum
    l_s e^(m_s - M) + p_new, 1e-30). (The kernels run the same function in
    base-2 units, logits times log2(e), with 2^x for e^x.) drop_split leaves
    that split of every row out of the merge: a fault the checks must
    reject."""
    B, H, hd = q.shape
    _, K, P, _ = k_pages.shape
    n_pages = page_tables.shape[1]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, K, G, hd)
    out = torch.empty((B, K, G, hd), dtype=torch.float32, device=q.device)
    for b in range(B):
        length = int(lengths[b])
        lo_tok = max(0, length - window + 1) if window is not None else 0
        lo, hi = lo_tok // P, min(-(-length // P), n_pages)
        c = -(-max(0, hi - lo) // n_split)
        ms, ls, accs = [], [], []
        for s in range(n_split):
            t0, t1 = lo + s * c, min(hi, lo + (s + 1) * c)
            if t1 <= t0 or s == drop_split:
                continue           # weighs 0 in the merge
            pages = page_tables[b, t0:t1].long().to(k_pages.device)
            kk = k_pages[pages].permute(1, 0, 2, 3).reshape(K, -1, hd).float()
            vv = v_pages[pages].permute(1, 0, 2, 3).reshape(K, -1, hd).float()
            jk = torch.arange(t0 * P, t1 * P, device=q.device)
            vis = (jk < length) & (jk >= lo_tok)
            logits = _cap(torch.einsum("kgd,ksd->kgs", qf[b], kk) * scale,
                          softcap)
            logits = torch.where(vis, logits, torch.full_like(logits, NEG_INF))
            m = logits.amax(dim=-1)
            p = torch.where(vis, torch.exp(logits - m[..., None]),
                            torch.zeros_like(logits))
            ms.append(m)
            ls.append(p.sum(dim=-1))
            accs.append(torch.einsum("kgs,ksd->kgd", p, vv))
        M = torch.full((K, G), NEG_INF, device=q.device)
        for m in ms:
            M = torch.maximum(M, m)
        if k_new is not None:
            ln = _cap(torch.einsum("kgd,kd->kg", qf[b], k_new[b].float())
                      * scale, softcap)
            M = torch.maximum(M, ln)
        L = torch.zeros((K, G), device=q.device)
        A = torch.zeros((K, G, hd), device=q.device)
        for m, l, acc in zip(ms, ls, accs):
            w = torch.exp(m - M)
            L = L + l * w
            A = A + acc * w[..., None]
        if k_new is not None:
            pn = torch.exp(ln - M)
            L = L + pn
            A = A + pn[..., None] * v_new[b].float()[:, None, :]
        out[b] = A / L.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


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


def paged_mla_decode_split_ref(q_abs, q_rope, ckv_pages, kr_pages,
                               page_tables, lengths, c_new, r_new, *,
                               scale: float, n_split: int,
                               drop_split: Optional[int] = None
                               ) -> torch.Tensor:
    """The split-and-merge arithmetic of the K3/K4 kernels, in plain fp32
    PyTorch, for the tests and the smoke's planted fault (the wrappers take
    :func:`paged_mla_decode_attention_ref` on the CPU). Shapes as K4.

    Row b's visible pages [0, hi), hi = ceil(lengths[b] / P), go to n_split
    splits of c = ceil(hi / n_split) pages; split s keeps (m, l, acc) over
    the visible positions of pages [s c, min(hi, (s + 1) c)), masked ones
    weighing 0; an empty split is left out. The merge takes M = max(m_s,
    logit_new) and gives (sum acc_s e^(m_s - M) + p_new c_new) / max(sum
    l_s e^(m_s - M) + p_new, 1e-30). (The kernels run the same function in
    base-2 units, with P rounded to bf16 before the value product.)
    drop_split leaves that split of every row out of the merge: a fault the
    checks must reject."""
    B, H, kvr = q_abs.shape
    P = ckv_pages.shape[1]
    n_pages = page_tables.shape[1]
    qa, qr = q_abs.float(), q_rope.float()
    out = torch.empty((B, H, kvr), dtype=torch.float32, device=q_abs.device)
    for b in range(B):
        length = int(lengths[b])
        hi = min(-(-length // P), n_pages)
        c = -(-hi // n_split)
        ms, ls, accs = [], [], []
        for s in range(n_split):
            t0, t1 = s * c, min(hi, (s + 1) * c)
            if t1 <= t0 or s == drop_split:
                continue           # weighs 0 in the merge
            pages = page_tables[b, t0:t1].long().to(ckv_pages.device)
            cc = ckv_pages[pages].reshape(-1, kvr).float()
            rr = kr_pages[pages].reshape(cc.shape[0], -1).float()
            vis = torch.arange(t0 * P, t1 * P, device=q_abs.device) < length
            logits = (qa[b] @ cc.T + qr[b] @ rr.T) * scale         # (H, S)
            logits = torch.where(vis, logits, torch.full_like(logits, NEG_INF))
            m = logits.amax(dim=-1)
            p = torch.where(vis, torch.exp(logits - m[:, None]),
                            torch.zeros_like(logits))
            ms.append(m)
            ls.append(p.sum(dim=-1))
            accs.append(p @ cc)
        M = torch.full((H,), NEG_INF, device=q_abs.device)
        for m in ms:
            M = torch.maximum(M, m)
        if c_new is not None:
            ln = (qa[b] @ c_new[b].float() + qr[b] @ r_new[b].float()) * scale
            M = torch.maximum(M, ln)
        L = torch.zeros((H,), device=q_abs.device)
        A = torch.zeros((H, kvr), device=q_abs.device)
        for m, l, acc in zip(ms, ls, accs):
            w = torch.exp(m - M)
            L = L + l * w
            A = A + acc * w[:, None]
        if c_new is not None:
            pn = torch.exp(ln - M)
            L = L + pn
            A = A + pn[:, None] * c_new[b].float()[None, :]
        out[b] = A / L.clamp_min(1e-30)[:, None]
    return out.to(q_abs.dtype)


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
    if hd % 8 or not 16 <= hd <= PAGED_MAX_HD:
        raise ValueError(f"head dim {hd}: the kernel takes whole 16-byte "
                         f"granules of bf16, from 16 to {PAGED_MAX_HD}")
    if H // K > PAGED_MAX_GROUP:
        raise ValueError(f"{H // K} query heads per kv head: the kernel holds "
                         f"at most {PAGED_MAX_GROUP}")
    if any(t is not None and t.data_ptr() % 16 for t in (q, k_new, v_new)):
        raise ValueError("q, k_new and v_new must start on 16-byte "
                         "boundaries")
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


@functools.lru_cache(maxsize=256)
def split_plan_for(cfg: PULConfig, q_shape, plane_shape, n_pages: int,
                   sms: int, n_split: Optional[int] = None) -> SplitPlan:
    """The plan both K1 and K2 launch with: q (B, H, hd) over planes whose
    last three dims are (K, P, hd), K1's (L, NF, K, P, hd) or K2's (NP, K,
    P, hd); the planes' leading dims and the layer do not enter it. Cached:
    the decode step asks once per layer with the same shapes."""
    B, H, hd = q_shape
    K, P = plane_shape[-3], plane_shape[-2]
    return paged_split_plan(cfg, B=B, K=K, G=H // K, P=P, hd=hd,
                            n_pages=n_pages, sms=sms, n_split=n_split)


def _split_launch(cfg: PULConfig, q, plane_shape, page_tables,
                  n_split: Optional[int]):
    """K1/K2's plan and fp32 workspace: one allocation on the caller's
    stream, viewed as m and l (B, K, n_split, G) and acc (B, K, n_split, G,
    hd)."""
    B, H, hd = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = split_plan_for(cfg, tuple(q.shape), tuple(plane_shape),
                          page_tables.shape[1], sms, n_split)
    n = B * H * plan.n_split
    work = torch.empty(n * (hd + 2), dtype=torch.float32, device=q.device)
    return plan, (work[:n], work[n:2 * n], work[2 * n:])


def pul_paged_decode_attention(q, k_pages, v_pages, page_tables, lengths, *,
                               cfg: PULConfig = PULConfig(),
                               scale: Optional[float] = None,
                               softcap: Optional[float] = None,
                               window: Optional[int] = None,
                               k_new=None, v_new=None,
                               n_split: Optional[int] = None) -> torch.Tensor:
    """K2: decode attention straight over one layer's page frames.

    q (B, H, hd); k_pages/v_pages (NP, K, P, hd); page_tables (B, n_pages)
    int32; lengths (B,) int32; k_new/v_new (B, K, hd), the current token,
    folded into the online softmax after the page stream. Returns (B, H, hd).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, hd a multiple of 8 from 16 to 256, G <= 16), split as
    :func:`paged_split_plan` says unless n_split is given."""
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
    plan, work = _split_launch(cfg, q, k_pages.shape, page_tables, n_split)
    out = torch.empty_like(q)
    rc = lib("pul_paged_decode").pul_paged_decode(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(page_tables),
        _ptr(lengths), _ptr(k_new), _ptr(v_new), _ptr(out), *map(_ptr, work),
        B, K, H // K, P, hd, page_tables.shape[1], plan.n_split,
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
                                     window: Optional[int] = None,
                                     n_split: Optional[int] = None
                                     ) -> torch.Tensor:
    """K1: one layer step of the single-sweep paged decode.

    q (B, H, hd); k_planes/v_planes (L, NF, K, P, hd), the ENTIRE per-layer
    store, never sliced on the host; layer: the plane row to read; k_new /
    v_new (B, K, hd), merged into the online softmax AND written to plane
    position (layer, frames[b], kv_h, offsets[b]); frames/offsets (B,) int32
    (the TRASH frame for inactive slots). Returns out (B, H, hd); the planes
    are updated in place. On the card the split count is K2's
    (:func:`paged_split_plan`) unless n_split is given."""
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
    plan, work = _split_launch(cfg, q, k_planes.shape, page_tables, n_split)
    out = torch.empty_like(q)
    rc = lib("pul_paged_decode").pul_paged_sweep_decode(
        _ptr(q), _ptr(k_planes), _ptr(v_planes), _ptr(page_tables),
        _ptr(lengths), _ptr(k_new), _ptr(v_new), _ptr(frames), _ptr(offsets),
        _ptr(out), *map(_ptr, work), B, K, H // K, P, hd,
        page_tables.shape[1], NF, int(layer), plan.n_split,
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
    if kvr % 32 or not 32 <= kvr <= MLA_MAX_KVR:
        raise ValueError(f"a c_kv row of {kvr}: the kernel takes multiples of "
                         f"32 from 32 to {MLA_MAX_KVR} (a warp's half of the "
                         "value columns in whole 16-column tiles)")
    if dr % 8 or dr < 8:
        raise ValueError(f"a k_rope row of {dr} values is not a whole number "
                         "of 16-byte cp.async granules")
    if any(t.data_ptr() % 16 for t in (q_abs, q_rope, ckv, kr, c_new, r_new)):
        raise ValueError("q_abs, q_rope, the planes, c_new and r_new must "
                         "start on 16-byte boundaries")
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


@functools.lru_cache(maxsize=256)
def mla_split_plan_for(cfg: PULConfig, B: int, H: int, P: int, kvr: int,
                       dr: int, n_pages: int, sms: int,
                       n_split: Optional[int] = None) -> SplitPlan:
    """:func:`mla_split_plan`, cached: the decode step asks once per layer
    with the same shapes, and K3 and K4 ask with the same."""
    return mla_split_plan(cfg, B=B, H=H, P=P, kvr=kvr, dr=dr,
                          n_pages=n_pages, sms=sms, n_split=n_split)


def _mla_split_launch(cfg: PULConfig, q_abs, P: int, dr: int, page_tables,
                      n_split: Optional[int]):
    """K3/K4's plan and fp32 workspace: one allocation on the caller's
    stream, viewed as acc (B, n_split, H, kvr) first (its float4 reads stay
    16-byte aligned), then m and l (B, n_split, H)."""
    B, H, kvr = q_abs.shape
    sms = torch.cuda.get_device_properties(q_abs.device).multi_processor_count
    plan = mla_split_plan_for(cfg, B, H, P, kvr, dr, page_tables.shape[1],
                              sms, n_split)
    n = B * plan.n_split * H
    work = torch.empty(n * (kvr + 2), dtype=torch.float32,
                       device=q_abs.device)
    return plan, (work[n * kvr:n * (kvr + 1)], work[n * (kvr + 1):],
                  work[:n * kvr])


def pul_paged_mla_decode_attention(q_abs, q_rope, ckv_pages, kr_pages,
                                   page_tables, lengths, c_new, r_new, *,
                                   scale: float,
                                   cfg: PULConfig = PULConfig(),
                                   n_split: Optional[int] = None
                                   ) -> torch.Tensor:
    """K4: absorbed-MLA decode attention straight over one layer's
    compressed-KV page frames.

    q_abs (B, H, kvr): queries absorbed into the compressed space; q_rope
    (B, H, dr); ckv_pages (NP, P, kvr) and kr_pages (NP, P, dr); page_tables
    (B, n_pages) int32; lengths (B,) int32; c_new / r_new (B, kvr) / (B, dr),
    the current token, folded in after the page stream. Returns o_c
    (B, H, kvr); the caller applies the absorbed v up-projection. CPU
    tensors take the plain version; CUDA tensors launch the kernel (bf16,
    kvr a multiple of 32 up to 512, dr a multiple of 8), split as
    :func:`mla_split_plan` says unless n_split is given."""
    if q_abs.device.type == "cpu":
        return paged_mla_decode_attention_ref(
            q_abs, q_rope, ckv_pages, kr_pages, page_tables, lengths, c_new,
            r_new, scale=scale)
    _check_mla(q_abs, q_rope, ckv_pages, kr_pages, page_tables, lengths,
               c_new, r_new)
    B, H, kvr = q_abs.shape
    NP, P, _ = ckv_pages.shape
    dr = q_rope.shape[-1]
    plan, work = _mla_split_launch(cfg, q_abs, P, dr, page_tables, n_split)
    out = torch.empty_like(q_abs)
    rc = lib("pul_paged_mla_decode").pul_paged_mla_decode(
        _ptr(q_abs), _ptr(q_rope), _ptr(ckv_pages), _ptr(kr_pages),
        _ptr(page_tables), _ptr(lengths), _ptr(c_new), _ptr(r_new), _ptr(out),
        *map(_ptr, work), B, H, P, kvr, dr, page_tables.shape[1],
        plan.n_split, scale, plan.distance, plan.slots,
        int(cfg.strategy is IssueStrategy.SEQUENTIAL), plan.smem_bytes,
        _stream(q_abs))
    _raise_on(rc, "pul_paged_mla_decode")
    LAUNCHES["k4"] += 1
    return out


def pul_paged_sweep_mla_decode_attention(q_abs, q_rope, ckv_planes, kr_planes,
                                         layer: int, page_tables, lengths,
                                         c_new, r_new, frames, offsets, *,
                                         scale: float,
                                         cfg: PULConfig = PULConfig(),
                                         n_split: Optional[int] = None
                                         ) -> torch.Tensor:
    """K3: absorbed-MLA layer step of the single-sweep paged decode.

    ckv_planes (L, NF, P, kvr), kr_planes (L, NF, P, dr): the ENTIRE
    per-layer compressed store; layer: the plane row to read; c_new / r_new
    (B, kvr) / (B, dr) are merged into the online softmax AND written to
    (layer, frames[b], offsets[b]); frames/offsets (B,) int32 (the TRASH
    frame for inactive slots). Returns o_c (B, H, kvr); the planes are
    updated in place. On the card the split count is K4's
    (:func:`mla_split_plan`) unless n_split is given."""
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
    plan, work = _mla_split_launch(cfg, q_abs, P, dr, page_tables, n_split)
    out = torch.empty_like(q_abs)
    rc = lib("pul_paged_mla_decode").pul_paged_sweep_mla_decode(
        _ptr(q_abs), _ptr(q_rope), _ptr(ckv_planes), _ptr(kr_planes),
        _ptr(page_tables), _ptr(lengths), _ptr(c_new), _ptr(r_new),
        _ptr(frames), _ptr(offsets), _ptr(out), *map(_ptr, work),
        B, H, P, kvr, dr, page_tables.shape[1], NF, int(layer), plan.n_split,
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
    tc = attention_body(q.dtype) == TC_BODY
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
