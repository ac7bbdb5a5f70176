"""Decode attention over a dense cache (K6): one query token per head
against a long (B, K, S, hd) KV cache masked at each row's length.

:func:`pul_decode_attention` replaces the reference's
``kernels/pul_decode.py::pul_decode_attention``, with its signature minus
``interpret`` (plus ``seg_chunks``, to force the segment size). The kernel is
CUDA C++ for Hopper, in ``csrc/pul_dense_attention.cu`` beside the flash
attention K7 (see the note at its head): split-KV on a persistent grid. The
chunks every (b, kv head) row streams (ceil(length / chunk_keys), the whole
padded stream at length 0) are cut into segments, balanced over the grid
on the card from ``lengths`` (the host never reads them); each block streams
its segments through a ring of 1D bulk copies and writes one fp32 (m, l,
acc) per piece of a row, and a second kernel merges each row's pieces.
:func:`decode_ring_plan` budgets the ring for three blocks an SM and bounds
the pieces a row can have; :func:`decode_pieces` is the cut the card makes.

Beside it are the plain version :func:`decode_attention_kernel_ref`, what the
reference's Pallas kernel computes, and :func:`decode_attention_split_ref`,
the kernel's split-and-merge arithmetic in plain PyTorch. The wrapper takes
the first only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises. ``LAUNCHES["k6"]`` counts its launches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.pul import PULConfig
from repro_torch.kernels._runtime import (
    LAUNCHES,
    _blocks_per_sm,
    _check,
    _plan,
    _ptr,
    _raise_on,
    lib,
)
from repro_torch.kernels.pul_attention import (
    DENSE_DTYPES,
    NEG_INF,
    _cap,
    _check_dense,
    _check_options,
    _dense_args,
    _stream_softmax,
    padded_stream,
    stream_length,
)

#: query heads of one kv head the kernel holds (the source's kMaxG)
MAX_GROUP = 16
#: the body that runs on the card: split-KV, fp32 FMAs on the CUDA cores
DECODE_BODY = "split-kv"
#: bytes of one ring chunk's K and V rows, at most (the source's
#: kDecChunkBytes)
DECODE_CHUNK_BYTES = 32768
#: shared memory of one SM (228 KB) and what the card keeps of it per block
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_SMEM = 1024
#: blocks of the split kernel an SM holds (its registers are budgeted for
#: three, as is its ring), and the shared memory that leaves one block
DECODE_BLOCKS_PER_SM = 3
DECODE_SMEM_BYTES = SM_SMEM_BYTES // DECODE_BLOCKS_PER_SM - BLOCK_RESERVED_SMEM
#: pieces a row may have when the segments are balanced over the grid
DECODE_PIECES = 64
#: warps of a split block
DECODE_WARPS = 4


def heads_per_warp(G: int) -> int:
    """Query heads one warp of a split block carries (the kernel's HPW): 2
    where G <= 2, else 4."""
    return 2 if G <= 2 else 4


def _exchange_bytes(hd: int, G: int) -> int:
    """A split block's merge exchange (4 warps x heads_per_warp(G) x (hd +
    2) fp32) and its chunk total (16 B): the source's Dec::kXBytes."""
    return DECODE_WARPS * heads_per_warp(G) * (hd + 2) * 4 + 16


def decode_chunk_keys(hd: int, itemsize: int, G: int = 2) -> int:
    """Keys of one K6 ring chunk (the source's Dec::kBC): the power of two
    whose K and V rows come nearest DECODE_CHUNK_BYTES from below, and two
    of them fit DECODE_SMEM_BYTES beside the exchange, within [8, 128]: 64
    at hd 128 bf16 (32 KB), 32 at hd 128 f32, 16 at hd 256 bf16 with G > 2.
    The plan passes it to the kernel, which refuses a plan whose chunk is
    not its own (and whose n_piece does not bound a row's pieces)."""
    cap = (DECODE_SMEM_BYTES - _exchange_bytes(hd, G)) // 2 - 16
    rows = min(cap, DECODE_CHUNK_BYTES) // 2 // (hd * itemsize)
    keys = 1 << (max(rows, 1).bit_length() - 1)
    return min(128, max(8, keys))


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    distance: int       # KV chunks preloaded ahead of the compute
    slots: int          # ring slots, each one chunk of K and V rows
    smem_bytes: int     # dynamic shared memory of one block
    chunk_keys: int     # keys of one ring chunk
    n_chunks: int       # chunks of the padded stream
    seg_chunks: int     # chunks of a segment, forced (0: balanced)
    min_seg: int        # chunks a balanced segment takes at least
    n_piece: int        # partial slots of a row (bounds its pieces)
    blocks_per_sm: int  # split blocks an SM holds
    grid: int           # split blocks: SMs x blocks_per_sm


def decode_ring_plan(cfg: PULConfig, *, B: int, K: int, G: int, s_pad: int,
                     hd: int = 128, itemsize: int = 2, sms: int = 132,
                     blocks_per_sm: Optional[int] = None,
                     seg_chunks: Optional[int] = None) -> DecodePlan:
    """K6's ring and cut. A slot holds one chunk (decode_chunk_keys keys of
    K, then of V, unpadded: two bulk copies) and its two 8-byte mbarriers;
    beside the ring a block keeps the exchange of its warps' (m, l, acc),
    4 warps x heads_per_warp(G) x (hd + 2) fp32, and its chunk total
    (16 B). The ring is budgeted at DECODE_SMEM_BYTES, so that three blocks
    share an SM: at hd 128 bf16 and G 2, 2 slots of 32 KB (d = 2 BATCH, 1
    SEQUENTIAL), 69,744 B. blocks_per_sm
    is the card's occupancy query (the wrapper passes it); without it, what
    shared memory allows, at most the three the kernel's registers are
    budgeted for. The grid is one wave, sms x blocks_per_sm. With
    seg_chunks the segments have that many chunks and a row at most
    ceil(n_chunks / seg_chunks) + 1 pieces; without, the card balances
    them over the grid, at least min_seg chunks each, so a row has at most
    DECODE_PIECES (fewer for a short stream)."""
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"{G} query heads per kv head: the kernel holds "
                         f"1 to {MAX_GROUP}")
    keys = decode_chunk_keys(hd, itemsize, G)
    chunk = 2 * keys * hd * itemsize
    aux = _exchange_bytes(hd, G)
    ring = _plan(cfg, aux, chunk + 16, f"a {keys}-key K and V chunk",
                 limit=DECODE_SMEM_BYTES)
    n_chunks = -(-s_pad // keys)
    if seg_chunks is not None:
        if seg_chunks < 1:
            raise ValueError(f"seg_chunks {seg_chunks} is not positive")
        seg, min_seg = seg_chunks, 1
        n_piece = -(-n_chunks // seg) + 1
    else:
        seg, min_seg = 0, -(-n_chunks // (DECODE_PIECES - 1))
        n_piece = -(-n_chunks // min_seg) + 1
    if blocks_per_sm is None:
        blocks_per_sm = max(1, min(DECODE_BLOCKS_PER_SM, SM_SMEM_BYTES
                                   // (ring.smem_bytes + BLOCK_RESERVED_SMEM)))
    return DecodePlan(ring.distance, ring.slots, ring.smem_bytes, keys,
                      n_chunks, seg, min_seg, n_piece, blocks_per_sm,
                      sms * blocks_per_sm)


def _vis_chunks(length: int, plan: DecodePlan) -> int:
    """Chunks row b streams: those holding a visible key; every chunk of the
    padded stream at length 0 (the row that sees nothing)."""
    if length <= 0:
        return plan.n_chunks
    return min(-(-length // plan.chunk_keys), plan.n_chunks)


def decode_pieces(plan: DecodePlan, lengths: Sequence[int], K: int
                  ) -> Tuple[int, Dict[Tuple[int, int], List[Tuple[int, int]]]]:
    """The cut the card makes: the chunks of every row (b, kv head), in
    that order, joined into one sequence and cut into segments of `seg`
    chunks (plan.seg_chunks, or the total over the grid, at least
    plan.min_seg). Returns (seg, the pieces of each row: chunk ranges
    [c0, c1) of the row, one per segment it meets)."""
    vis = [_vis_chunks(int(n), plan) for n in lengths]
    total = K * sum(vis)
    seg = plan.seg_chunks or max(plan.min_seg, -(-total // plan.grid))
    pieces, start = {}, 0
    for b, n in enumerate(vis):
        for kvh in range(K):
            pieces[b, kvh] = [
                (max(start, u * seg) - start, min(start + n, (u + 1) * seg)
                 - start)
                for u in range(start // seg, (start + n - 1) // seg + 1)]
            start += n
    return seg, pieces


def decode_attention_kernel_ref(q, k, v, length, *, bs: int = 128,
                                scale: Optional[float] = None,
                                softcap: Optional[float] = None
                                ) -> torch.Tensor:
    """Plain version of K6: what the reference's Pallas kernel computes, in
    fp32. q (B, H, hd); k, v (B, K, S, hd); length (B,): key jk of row b
    is visible when jk < length[b]. The stream is zero-padded to whole bs
    blocks, so a row of length 0 gets the sum of its v rows over the padded
    length, not the mean over S (the reference's oracle)."""
    B, H, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kp, s_pad = padded_stream(k.float(), bs)
    vp, _ = padded_stream(v.float(), bs)
    qf = q.float().reshape(B, K, G, hd)
    logits = _cap(torch.einsum("bkgd,bksd->bkgs", qf, kp) * scale, softcap)
    length = torch.as_tensor(length, device=q.device).long().reshape(B)
    vis = (torch.arange(s_pad, device=q.device)[None, :]
           < length[:, None])[:, None, None, :]
    out = _stream_softmax(logits, vis, vp)
    return out.reshape(B, H, hd).to(q.dtype)


def decode_attention_split_ref(q, k, v, length, *, bs: int = 128,
                               scale: Optional[float] = None,
                               softcap: Optional[float] = None,
                               plan: Optional[DecodePlan] = None,
                               cfg: PULConfig = PULConfig(), sms: int = 132,
                               seg_chunks: Optional[int] = None,
                               drop_piece: Optional[int] = None
                               ) -> torch.Tensor:
    """The split-and-merge arithmetic of the K6 kernels, in plain fp32
    PyTorch, for the tests and the smoke's planted fault (nothing on the
    card path calls it). Shapes as K6; plan defaults to decode_ring_plan's
    for these shapes (blocks_per_sm from shared memory).

    Each row's chunks are cut as :func:`decode_pieces` cuts them; piece
    [c0, c1) keeps (m, l, acc) over keys [c0 bs', min(c1 bs', s_pad)) of
    the zero-padded stream (bs' = plan.chunk_keys), masked keys at NEG_INF,
    and the merge takes M = max m and gives sum acc e^(m - M) / max(sum l
    e^(m - M), 1e-30). (The kernels run the same function in base-2 units,
    logits times log2(e), with 2^x for e^x.) drop_piece leaves that piece of
    every row that has it out of the merge: a fault the checks must
    reject."""
    B, H, hd = q.shape
    K, S = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s_pad = stream_length(S, bs)
    if plan is None:
        plan = decode_ring_plan(cfg, B=B, K=K, G=G, s_pad=s_pad, hd=hd,
                                itemsize=q.element_size(), sms=sms,
                                seg_chunks=seg_chunks)
    lengths = torch.as_tensor(length).reshape(B).tolist()
    _, pieces = decode_pieces(plan, lengths, K)
    kp, _ = padded_stream(k.float(), bs)
    vp, _ = padded_stream(v.float(), bs)
    qf = q.float().reshape(B, K, G, hd)
    bc = plan.chunk_keys
    out = torch.empty((B, K, G, hd), dtype=torch.float32, device=q.device)
    for (b, kvh), cuts in pieces.items():
        ms, ls, accs = [], [], []
        for i, (c0, c1) in enumerate(cuts):
            if i == drop_piece:
                continue
            j0, j1 = c0 * bc, min(c1 * bc, s_pad)
            kk, vv = kp[b, kvh, j0:j1], vp[b, kvh, j0:j1]
            logits = _cap(qf[b, kvh] @ kk.T * scale, softcap)
            vis = torch.arange(j0, j1, device=q.device) < lengths[b]
            logits = torch.where(vis, logits, torch.full_like(logits, NEG_INF))
            m = logits.amax(dim=-1)
            p = torch.exp(logits - m[:, None])
            ms.append(m)
            ls.append(p.sum(dim=-1))
            accs.append(p @ vv)
        M = torch.stack(ms).amax(dim=0)
        L = torch.zeros((G,), device=q.device)
        A = torch.zeros((G, hd), device=q.device)
        for m, l, acc in zip(ms, ls, accs):
            w = torch.exp(m - M)
            L = L + l * w
            A = A + acc * w[:, None]
        out[b, kvh] = A / L.clamp_min(1e-30)[:, None]
    return out.reshape(B, H, hd).to(q.dtype)


def pul_decode_attention(q, k, v, length, *, cfg: PULConfig = PULConfig(),
                         bs: int = 128, scale: Optional[float] = None,
                         softcap: Optional[float] = None,
                         seg_chunks: Optional[int] = None) -> torch.Tensor:
    """K6: q (B, H, hd), one token per head; k, v (B, K, S, hd) caches;
    length (B,) valid cache entries (<= S). Returns (B, H, hd) in q's type.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes f32 or bf16, hd in DENSE_HDS and G = H / K <= 16; bs keeps
    its meaning in the padded stream's length. seg_chunks forces the
    segment size (chunks of decode_chunk_keys keys); by default the card
    balances the segments over its grid."""
    B, H, hd = q.shape
    _, K, S, _ = k.shape
    if H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    _check_options(S, scale, softcap, None)
    if q.device.type == "cpu":
        return decode_attention_kernel_ref(q, k, v, length, bs=bs,
                                           scale=scale, softcap=softcap)
    G = H // K
    if G > MAX_GROUP:
        raise ValueError(f"{G} query heads per kv head: the kernel holds at "
                         f"most {MAX_GROUP}")
    _check_dense(q, k, v)
    length = torch.as_tensor(length, device=q.device).to(torch.int32)
    _check("length", length, (B,), torch.int32, q.device)
    s_pad = stream_length(S, bs)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    dtype = DENSE_DTYPES.index(q.dtype)
    plan = decode_ring_plan(cfg, B=B, K=K, G=G, s_pad=s_pad, hd=hd,
                            itemsize=q.element_size(), sms=sms,
                            seg_chunks=seg_chunks)
    plan = dataclasses.replace(plan, blocks_per_sm=_blocks_per_sm(
        "pul_dense_attention", hd, dtype, G, plan.smem_bytes))
    plan = dataclasses.replace(plan, grid=sms * plan.blocks_per_sm)
    out = torch.empty_like(q)
    part_m = torch.empty((B * K, plan.n_piece, G), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B * K, plan.n_piece, G, hd), dtype=torch.float32,
                           device=q.device)
    part_n = torch.empty((B * K,), dtype=torch.int32, device=q.device)
    rc = lib("pul_dense_attention").pul_decode_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(length), _ptr(out), _ptr(part_m),
        _ptr(part_l), _ptr(part_acc), _ptr(part_n), B, K, G, S, hd, s_pad,
        scale if scale is not None else 1.0 / math.sqrt(hd),
        softcap or 0.0, plan.chunk_keys, plan.seg_chunks, plan.min_seg,
        plan.n_piece,
        plan.grid, *_dense_args(cfg, plan, q))
    _raise_on(rc, "pul_decode_attention")
    LAUNCHES["k6"] += 1
    return out
