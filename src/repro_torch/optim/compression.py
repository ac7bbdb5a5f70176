"""Gradient compression (port of ``repro/optim/compression.py``): symmetric
per-tensor int8 quantization and its error-feedback form.

``quantize_int8`` maps x to round(x / scale) clipped to [-127, 127] with
scale = max|x| / 127 (1 for an all-zero tensor; round half to even, as
``jnp.round``); ``ef_quantize`` quantizes g + err and carries the residual
to the next step. The reference's collective forms (``ef_psum``,
``ef_psum_tree``, a quantized psum over a mesh axis) need a mesh and are not
ported here.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.module import flatten, unflatten


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    x = x.float()
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_quantize(g: torch.Tensor, err: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantize: q(g + err); new_err = (g + err) - deq(q)."""
    corrected = g.float() + err
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def init_error_state(params):
    """fp32 zeros shaped like every leaf of `params`."""
    return unflatten({k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in flatten(params)})
