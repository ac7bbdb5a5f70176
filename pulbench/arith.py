"""The benchmark's frozen yardstick: operations and bytes of the served
model's work, and the peaks of the card.

Copied from the port's arithmetic and frozen here, so that no later change
to the program moves the yardstick: the analytic forward FLOPs of
``repro_torch/benchmarks/flops.py`` (``active_params`` and the
per-layer attention terms of a dense GQA decoder) and the bytes a decode tick must move of
``chip_smoke._tick_bytes`` (every weight once, the embedding table only for
the rows a tick looks up unless the head reads it whole as a tied table,
and every cached K/V row a live slot's attention reads, once). Two choices
of this copy: FLOPs count the useful work of live slots and real prompt
tokens (no bucket padding, no empty slots), and the head's bytes count the vocabulary's rows, not the
port's padded table.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Optional

from pulbench.spec import Arch
from pulbench.weights import nbytes as weight_bytes

BF16 = 2
PEAKS = json.loads(
    (Path(__file__).resolve().parent / "peaks.json").read_text())


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """{"bf16_flops", "hbm_bytes_per_s"} of a card by its name, or None."""
    return PEAKS.get(kind)


def active_params(a: Arch, head: bool = True) -> int:
    """Parameters that multiply a token's activations (the embedding lookup
    excluded, the output head included where `head`)."""
    D, H = a.d, a.heads
    attn = D * (H + 2 * a.kv_heads) * a.head_dim + H * a.head_dim * D
    n = a.layers * (attn + 3 * D * a.d_ff)
    return n + (a.vocab * D if head else 0)


def _score_flops(a: Arch, pairs: float) -> float:
    """FLOPs of the attention scores and the weighted values over `pairs`
    (query, key) pairs in one layer."""
    return 4 * a.heads * pairs * a.head_dim


def decode_flops(a: Arch, contexts: Iterable[int]) -> float:
    """One decode step of live slots whose caches hold `contexts` tokens
    each (the new token attends over its cache and itself)."""
    ctx = list(contexts)
    per_token = 2 * active_params(a)
    pairs = sum(c + 1 for c in ctx)
    return per_token * len(ctx) + a.layers * _score_flops(a, pairs)


def prefill_flops(a: Arch, prompt: int) -> float:
    """One prompt's prefill: every token through the layers, causal
    attention, and one row of the head."""
    pairs = prompt * (prompt + 1) / 2
    return (2 * active_params(a, head=False) * prompt + 2 * a.d * a.vocab
            + a.layers * _score_flops(a, pairs))


def decode_bytes(a: Arch, contexts: Iterable[int]) -> float:
    """Bytes a decode step must move at least: every weight once (the
    table's looked-up rows only where the head has its own matrix; the
    vocabulary's rows of a tied table), each live slot's cached rows once,
    and its new row written once."""
    ctx = list(contexts)
    w = weight_bytes(a)
    table = a.vocab_rows * a.d * BF16
    if a.tied:
        w = w - table + a.vocab * a.d * BF16
    else:
        w = w - table + len(ctx) * a.d * BF16
        w = w - (a.vocab_rows - a.vocab) * a.d * BF16      # lm_head's pad rows
    return w + a.kv_row_bytes * (sum(ctx) + len(ctx))


def attention_kernel_bytes(a: Arch, contexts: Iterable[int]) -> float:
    """Bytes one paged decode attention launch (one layer of K1) must
    move: each live slot's cached K/V rows of that layer once, its query
    read, its output written, and its new row read and committed."""
    ctx = list(contexts)
    row = 2 * a.kv_heads * a.head_dim * BF16
    q = out = a.heads * a.head_dim * BF16
    return row * sum(ctx) + len(ctx) * (q + out + 2 * row)
