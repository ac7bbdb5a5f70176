"""What both plain references share: fp32 math with TF32 off, RMSNorm with
the stored scale offset, rotary embedding, causal attention in blocks of
queries, the weight precision of a run (as stored, or fp8 for the control)
and the comparison of served tokens with the reference's logits.

Imports torch only: nothing of the port, of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

#: query rows of one block of attention scores
Q_BLOCK = 1024
#: positions of one block of the output head
HEAD_BLOCK = 2048


@contextlib.contextmanager
def fp32_exact():
    """fp32 products in fp32 (no TF32) for the duration."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """`w` stored as float8 e4m3 with one scale per output column (its
    last axis), back in fp32: the control's weight precision."""
    x = w.float()
    red = tuple(range(x.dim() - 1)) if x.dim() > 1 else ()
    amax = x.abs().amax(dim=red, keepdim=True) if red else x.abs().amax()
    scale = torch.clamp(amax, min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Weights:
    """fp32 copies of a run's bf16 weights on demand, one leaf (or one row
    of a stacked leaf) at a time; ``fp8`` takes each bf16 matrix through
    float8 first (the control)."""

    def __init__(self, tree: Dict, fp8: bool = False):
        self.tree = tree
        self.fp8 = fp8

    def leaf(self, path: str) -> torch.Tensor:
        node = self.tree
        for k in path.split("/"):
            node = node[k]
        return node

    def get(self, path: str, row: Optional[int] = None) -> torch.Tensor:
        w = self.leaf(path)
        if row is not None:
            w = w[row]
        if self.fp8 and w.dtype == torch.bfloat16 and w.dim() >= 2:
            return fp8_weight(w)
        return w.float()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * (1 + scale): the stored scale is an offset from one."""
    rms = torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return x * rms * (1.0 + scale)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding over the last axis in two halves (rotate-half):
    x (T, ..., d), positions (T,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (half,)
    cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Softmax attention of queries q (T, H, d) over keys k (S, H, d) and
    values v (S, H, dv), key j visible to query i where k_pos[j] <=
    q_pos[i]; in blocks of Q_BLOCK queries. Returns (T, H, dv)."""
    out = []
    for lo in range(0, q.shape[0], Q_BLOCK):
        qb = q[lo:lo + Q_BLOCK]
        s = torch.einsum("thd,shd->hts", qb, k) * scale
        mask = k_pos[None, :] <= q_pos[lo:lo + Q_BLOCK, None]
        s = s.masked_fill(~mask[None], float("-inf"))
        out.append(torch.einsum("hts,shv->thv", torch.softmax(s, -1), v))
    return torch.cat(out)


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ gate) * (x @ up)) @ down


def head_gaps(hidden: torch.Tensor, head: torch.Tensor, vocab: int,
              served: torch.Tensor,
              control_head: Optional[torch.Tensor] = None,
              control_hidden: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit at the
    served token (hidden (N, D) fp32 after the final norm, head (V, D),
    served (N,) token ids). With a control (its own hidden states and
    head), the token the control puts first stands in for the served one.
    Returns (N,) fp32 gaps, 0 where the token is the reference's best."""
    gaps = []
    for lo in range(0, hidden.shape[0], HEAD_BLOCK):
        h = hidden[lo:lo + HEAD_BLOCK]
        logits = (h @ head[:vocab].T)
        if control_head is not None:
            c = control_hidden[lo:lo + HEAD_BLOCK] @ control_head[:vocab].T
            tok = c.argmax(-1)
        else:
            tok = served[lo:lo + HEAD_BLOCK]
        best = logits.max(-1).values
        gaps.append(best - logits.gather(-1, tok[:, None].long())[:, 0])
    return torch.cat(gaps)


def teacher_tokens(prompt: Sequence[int], served: Sequence[int]) -> List[int]:
    """The tokens a teacher-forced pass reads: the prompt and every served
    token but the last (whose successor was never asked for)."""
    return list(prompt) + list(served[:-1])
