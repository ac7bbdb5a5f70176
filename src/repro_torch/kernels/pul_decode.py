"""Decode attention over a dense cache (K6): one query token per head
against a long (B, K, S, hd) KV cache masked at each row's length.

:func:`pul_decode_attention` replaces the reference's
``kernels/pul_decode.py::pul_decode_attention``, with its signature minus
``interpret``. The kernel is CUDA C++ for Hopper, in
``csrc/pul_dense_attention.cu`` beside the flash attention K7 (see the note
at its head): a block holds the G query heads of one kv head over one
segment of the cache, the segment's KV chunks stream through the PUL ring,
and a second kernel merges the segments' softmax states.
:func:`decode_ring_plan` budgets the ring against shared memory and cuts
the cache into segments.

Beside it is the plain version :func:`decode_attention_kernel_ref`, what the
reference's Pallas kernel computes. The wrapper takes it only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES["k6"]`` counts its launches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.pul import PULConfig
from repro_torch.kernels._runtime import (
    LAUNCHES,
    _check,
    _plan,
    _ptr,
    _raise_on,
    lib,
)
from repro_torch.kernels.pul_attention import (
    _cap,
    _check_dense,
    _check_options,
    _dense_args,
    _stream_softmax,
    kv_chunk_rows,
    kv_slot_bytes,
    padded_stream,
    stream_length,
)

#: query heads of one kv head a K6 block holds (the source's kMaxG)
MAX_GROUP = 16


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    distance: int       # KV chunks preloaded ahead of the compute
    slots: int          # ring slots, each one chunk of K and V rows
    smem_bytes: int     # dynamic shared memory of one block
    seg_chunks: int     # ring chunks of one segment (one block's keys)
    n_seg: int          # segments of the padded stream


def decode_ring_plan(cfg: PULConfig, *, B: int, K: int, G: int, s_pad: int,
                     hd: int = 128, itemsize: int = 2,
                     sms: int = 132) -> DecodePlan:
    """K6's ring and segments. A slot holds one KV chunk (as K7's); besides
    the ring a block keeps its G queries in fp32, the chunk's (G, chunk)
    logits and m/l/corr (G,). The padded stream of s_pad keys is cut into
    segments of seg_chunks chunks, enough for about 8 blocks per SM over
    B K (b, kv head) pairs at full length, and never fewer than 2d chunks,
    so the ring warms up once per segment, not once per chunk. At the
    smoke's B = 8, K = 8, S = 32768 bf16: 32 chunks (2,048 keys), 16
    segments."""
    rows = kv_chunk_rows(itemsize)
    aux = (G * hd + G * rows + 3 * G) * 4
    ring = _plan(cfg, aux, kv_slot_bytes(hd, itemsize),
                 f"a {rows}-key K and V chunk")
    n_chunks = -(-s_pad // rows)
    seg = max(2 * ring.distance, -(-n_chunks * B * K // (8 * sms)))
    seg = min(seg, n_chunks)
    return DecodePlan(ring.distance, ring.slots, ring.smem_bytes, seg,
                      -(-n_chunks // seg))


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


def pul_decode_attention(q, k, v, length, *, cfg: PULConfig = PULConfig(),
                         bs: int = 128, scale: Optional[float] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """K6: q (B, H, hd), one token per head; k, v (B, K, S, hd) caches;
    length (B,) valid cache entries (<= S). Returns (B, H, hd) in q's type.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes f32 or bf16, hd in DENSE_HDS and G = H / K <= 16; bs keeps
    its meaning in the padded stream's length."""
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
    plan = decode_ring_plan(cfg, B=B, K=K, G=G, s_pad=s_pad, hd=hd,
                            itemsize=q.element_size(), sms=sms)
    out = torch.empty_like(q)
    part_m = torch.empty((B, K, plan.n_seg, G), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, K, plan.n_seg, G, hd), dtype=torch.float32,
                           device=q.device)
    rc = lib("pul_dense_attention").pul_decode_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(length), _ptr(out), _ptr(part_m),
        _ptr(part_l), _ptr(part_acc), B, K, G, S, hd, s_pad,
        scale if scale is not None else 1.0 / math.sqrt(hd),
        softcap or 0.0, plan.seg_chunks, plan.n_seg,
        *_dense_args(cfg, plan, q))
    _raise_on(rc, "pul_decode_attention")
    LAUNCHES["k6"] += 1
    return out
