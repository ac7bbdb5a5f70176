"""The benchmark's frozen yardstick: operations and bytes of the served
model's work, and the peaks of the card.

The operations and bytes depend on the model's family, so each entry point
calls the one of ``families/<family>.py`` that the arch names (the dense
GQA decoder's, copied from the port's arithmetic and frozen there); the
peaks are the card's, ``peaks.json``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Optional

from pulbench import families

PEAKS = json.loads(
    (Path(__file__).resolve().parent / "peaks.json").read_text())


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """{"bf16_flops", "hbm_bytes_per_s"} of a card by its name, or None."""
    return PEAKS.get(kind)


def active_params(a, head: bool = True) -> int:
    """Parameters that multiply a token's activations (the embedding lookup
    excluded, the output head included where `head`)."""
    return families.family(a.family).active_params(a, head)


def decode_flops(a, contexts: Iterable[int]) -> float:
    """One decode step of live slots whose caches hold `contexts` tokens
    each (the new token attends over its cache and itself)."""
    return families.family(a.family).decode_flops(a, contexts)


def prefill_flops(a, prompt: int) -> float:
    """One prompt's prefill: every token through the layers, causal
    attention, and one row of the head."""
    return families.family(a.family).prefill_flops(a, prompt)


def decode_bytes(a, contexts: Iterable[int]) -> float:
    """Bytes a decode step must move at least: every weight once, each
    live slot's cached rows once, and its new row written once."""
    return families.family(a.family).decode_bytes(a, contexts)


def attention_kernel_bytes(a, contexts: Iterable[int]) -> float:
    """Bytes one paged decode attention launch (one layer) must move: each
    live slot's cached rows of that layer once, its query read, its output
    written, and its new row read and committed."""
    return families.family(a.family).attention_kernel_bytes(a, contexts)
