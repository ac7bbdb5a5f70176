"""Plain reference of a dense decoder with grouped-query attention (the
Qwen3 family): RMSNorm before attention and MLP, per-head RMSNorm of q and
k (``qk_norm``), rotary embedding in two halves at ``rope_theta``, causal
softmax attention with kv head h // (H / K) serving query head h, a SwiGLU
MLP, a final RMSNorm and the output head (the embedding table where tied).

fp32 throughout, TF32 off (``common.fp32_exact``); each weight is read
from the run's bf16 tree and widened one layer at a time. Requests are
independent, so each is its own teacher-forced pass: the prompt and the
served tokens read at once, causally.

Imports torch only: nothing of the port, of JAX or of the JAX package.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from pulbench.reference.common import (Weights, causal_attention, rms_norm,
                                       rope, swiglu, teacher_tokens)


def _attention(x, w: Weights, a, layer: int, pos):
    g = lambda name: w.get(f"groups/0:global/attn/{name}", row=layer)
    T = x.shape[0]
    q = torch.einsum("td,dhk->thk", x, g("wq"))
    k = torch.einsum("td,dhk->thk", x, g("wk"))
    v = torch.einsum("td,dhk->thk", x, g("wv"))
    if a.qk_norm:
        q = rms_norm(q, g("q_norm"), a.eps)
        k = rms_norm(k, g("k_norm"), a.eps)
    q, k = rope(q, pos, a.rope_theta), rope(k, pos, a.rope_theta)
    group = a.heads // a.kv_heads
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    out = causal_attention(q, k, v, pos, pos, 1.0 / math.sqrt(a.head_dim))
    return torch.einsum("thk,hkd->td", out, g("wo"))


def final_hidden(w: Weights, a, sequences: Sequence[Sequence[int]],
                 first: Sequence[int]) -> List[torch.Tensor]:
    """For each token sequence, the final-normed hidden state (fp32) of
    every position from first[i] on."""
    table = w.leaf("embedding/table")
    dev = table.device
    xs = [table[torch.as_tensor(list(s), device=dev)].float()
          for s in sequences]
    for layer in range(a.layers):
        g = lambda name: w.get(f"groups/0:global/{name}", row=layer)
        for i, x in enumerate(xs):
            pos = torch.arange(x.shape[0], device=dev)
            x = x + _attention(rms_norm(x, g("norm1"), a.eps), w, a, layer,
                               pos)
            h = rms_norm(x, g("norm2"), a.eps)
            xs[i] = x + swiglu(h, g("mlp/w_gate"), g("mlp/w_up"),
                               g("mlp/w_down"))
    norm = w.get("final_norm")
    return [rms_norm(x[f:], norm, a.eps) for x, f in zip(xs, first)]


def hidden(w: Weights, a, requests: Sequence[Tuple[List[int], List[int]]],
           mix) -> torch.Tensor:
    """(N, d) fp32: the final-normed hidden state at each served position
    of `requests` ((prompt, served tokens) pairs), in order; N is the
    number of served tokens."""
    seqs = [teacher_tokens(p, s) for p, s in requests]
    first = [len(p) - 1 for p, _ in requests]
    return torch.cat(final_hidden(w, a, seqs, first))


def head(w: Weights, a) -> torch.Tensor:
    return w.get("embedding/table" if a.tied else "embedding/lm_head")
