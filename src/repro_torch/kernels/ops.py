"""Public entry points of the PUL kernels, with the reference's signatures
and defaults (``repro/kernels/ops.py``).

The reference's ``interpret`` switch has no counterpart: the device is the
tensors' own. CPU tensors take each kernel's plain version; CUDA tensors
launch the hand-written Hopper kernel or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.pul import PULConfig
from repro_torch.kernels.pul_attention import pul_attention
from repro_torch.kernels.pul_filter import pul_filter
from repro_torch.kernels.pul_gather import pul_gather
from repro_torch.kernels.pul_matmul import pul_matmul
from repro_torch.kernels.pul_sum import pul_sum


def sum_op(data, trace, *, cfg: PULConfig = PULConfig(),
           rows_per_req: int = 1):
    """The paper's SUM (K8): the fp32 sum of data[trace[i]*r : +r]."""
    return pul_sum(data, trace, cfg=cfg, rows_per_req=rows_per_req)


def gather_op(table, trace, *, cfg: PULConfig = PULConfig(),
              rows_per_req: int = 1):
    """The PUL random row gather (K5)."""
    return pul_gather(table, trace, cfg=cfg, rows_per_req=rows_per_req)


def matmul_op(a, b, *, cfg: PULConfig = PULConfig(), bm: int = 128,
              bk: int = 128, bn: int = 128,
              out_dtype: torch.dtype = torch.float32):
    """C = A B through PUL-streamed operand tiles (K10)."""
    return pul_matmul(a, b, cfg=cfg, bm=bm, bk=bk, bn=bn,
                      out_dtype=out_dtype)


def attention_op(q, k, v, *, cfg: PULConfig = PULConfig(), bt: int = 128,
                 bs: int = 128, causal: bool = True,
                 scale: Optional[float] = None,
                 softcap: Optional[float] = None,
                 window: Optional[int] = None):
    """Flash attention with PUL-streamed KV (K7): causal, GQA, window,
    softcap."""
    return pul_attention(q, k, v, cfg=cfg, bt=bt, bs=bs, causal=causal,
                         scale=scale, softcap=softcap, window=window)


def filter_op(data, threshold: float, *, cfg: PULConfig = PULConfig(),
              rows_per_block: int = 128, materialize: bool = False):
    """The paper's Exp. 5 filter with bit-vector unloading (K9)."""
    return pul_filter(data, threshold, cfg=cfg, rows_per_block=rows_per_block,
                      materialize=materialize)
