"""The plain PyTorch versions of the port's kernels, under the reference's
names (``repro/kernels/ref.py``): the allclose targets of the tests and of
``chip_smoke.py``. Each lives beside its kernel; this module gathers them,
and holds the attention oracles, copies of the reference's.

The oracles differ from what the attention kernels compute in two places,
as the reference's do from its Pallas kernels: :func:`attention_ref`
applies ``window`` only under ``causal``, and a row that sees no key gets
the mean of the v rows over S. The kernels' plain versions
(``pul_attention.attention_kernel_ref``,
``pul_decode.decode_attention_kernel_ref``) follow the kernels."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.pul_filter import filter_materialize_ref, filter_ref
from repro_torch.kernels.pul_gather import gather_ref
from repro_torch.kernels.pul_matmul import matmul_ref
from repro_torch.kernels.pul_sum import sum_ref

__all__ = ["sum_ref", "gather_ref", "matmul_ref", "attention_ref",
           "filter_ref", "filter_materialize_ref", "decode_attention_ref"]


def attention_ref(q, k, v, *, causal: bool = True,
                  scale: Optional[float] = None,
                  softcap: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,T,hd); k,v: (B,K,S,hd) with H % K == 0 (GQA)."""
    B, H, T, hd = q.shape
    K = k.shape[1]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kk = torch.repeat_interleave(k, G, dim=1)
    vv = torch.repeat_interleave(v, G, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), kk.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    S = k.shape[2]
    if causal:
        i = torch.arange(T, device=q.device)[:, None] + (S - T)
        j = torch.arange(S, device=q.device)[None, :]
        m = j <= i
        if window is not None:
            m &= j > i - window
        logits = torch.where(m[None, None], logits,
                             torch.full_like(logits, -2.0e38))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, vv.float()).to(q.dtype)


def decode_attention_ref(q, k, v, length, *, scale=None, softcap=None):
    """q: (B,H,hd); k,v: (B,K,S,hd); length: (B,) valid entries."""
    B, H, hd = q.shape
    K, S = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kk = torch.repeat_interleave(k, G, dim=1)
    vv = torch.repeat_interleave(v, G, dim=1)
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kk.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    length = torch.as_tensor(length, device=q.device)
    mask = torch.arange(S, device=q.device)[None, None, :] < length[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, -2.0e38))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vv.float()).to(q.dtype)
