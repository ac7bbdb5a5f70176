"""The dense decoder with grouped-query attention (the Qwen3 family): its
widths, read from the published config's own keys, the port's
configuration and weight layout for it, and its frozen yardstick.

The yardstick is copied from the port's arithmetic and frozen here, so that
no later change to the program moves it: the analytic forward FLOPs of
``repro_torch/benchmarks/flops.py`` (``active_params`` and the per-layer
attention terms of a dense GQA decoder) and the bytes a decode tick must
move of ``chip_smoke._tick_bytes`` (every weight once, the embedding table
only for the rows a tick looks up unless the head reads it whole as a tied
table, and every cached K/V row a live slot's attention reads, once). Two
choices of this copy: FLOPs count the useful work of live slots and real
prompt tokens (no bucket padding, no empty slots), and the head's bytes
count the vocabulary's rows, not the port's padded table.

Imports neither torch nor the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Tuple

from pulbench.families import BF16, F32, ITEMSIZE, VOCAB_CHUNK, layout_bytes

#: bytes of a bf16 element
BF16_BYTES = ITEMSIZE[BF16]

#: the published keys the CPU tests' tiny cells change; the port's
#: configuration is built from these, as at full size
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
        "vocab_size": 256, "num_hidden_layers": 2,
        "initializer_range": 0.125}

#: the port's ModelConfig field each published key gives
PORT_FIELDS = {"d_model": "hidden_size", "num_heads": "num_attention_heads",
               "num_kv_heads": "num_key_value_heads", "head_dim": "head_dim",
               "d_ff": "intermediate_size", "vocab_size": "vocab_size",
               "num_layers": "num_hidden_layers", "rope_theta": "rope_theta",
               "norm_eps": "rms_norm_eps",
               "tie_embeddings": "tie_word_embeddings"}


@dataclasses.dataclass(frozen=True)
class Arch:
    """The widths of one configuration as the benchmark reads them (the
    published config's keys), and the port's padded table rows."""

    name: str
    family: str                 # the reference's module: "dense_gqa"
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    vocab_rows: int             # the port's table rows (vocab padded)
    tied: bool
    rope_theta: float
    eps: float
    qk_norm: bool
    init_std: float             # the config's initializer_range

    @property
    def kv_row_bytes(self) -> int:
        """Bytes of one cached token over all layers (bf16)."""
        return self.layers * 2 * self.kv_heads * self.head_dim * 2


def _dense_gqa(cfg: Dict[str, Any]) -> None:
    """Raises where the published config asks for what the port's dense
    decoder does not compute."""
    unsupported = {
        "hidden_act": cfg.get("hidden_act", "silu") != "silu",
        "attention_bias": bool(cfg.get("attention_bias", False)),
        "rope_scaling": cfg.get("rope_scaling") is not None,
        "use_sliding_window": bool(cfg.get("use_sliding_window", False)),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"{cfg['name']}: the port's dense decoder does not "
                         f"compute {bad}")


def arch(cfg: Dict[str, Any]) -> Arch:
    _dense_gqa(cfg)
    vocab = cfg["vocab_size"]
    return Arch(
        name=cfg["name"], family=cfg["reference"], d=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab=vocab,
        vocab_rows=math.ceil(vocab / VOCAB_CHUNK) * VOCAB_CHUNK,
        tied=bool(cfg.get("tie_word_embeddings", False)),
        rope_theta=float(cfg["rope_theta"]), eps=float(cfg["rms_norm_eps"]),
        qk_norm=cfg.get("model_type") == "qwen3",
        init_std=float(cfg.get("initializer_range", 0.02)))


def port_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The keyword arguments of the port's ``ModelConfig`` for `cfg`, from
    the published keys alone (the same that ``arch`` reads)."""
    a = arch(cfg)
    return dict(
        name=a.name, family="dense", num_layers=a.layers, d_model=a.d,
        num_heads=a.heads, num_kv_heads=a.kv_heads, head_dim=a.head_dim,
        d_ff=a.d_ff, vocab_size=a.vocab, pattern=("global",),
        mlp_type="swiglu", qk_norm=a.qk_norm, rope_theta=a.rope_theta,
        tie_embeddings=a.tied, norm_eps=a.eps, vocab_chunk=VOCAB_CHUNK)


# ------------------------------------------------------------------------ #
# the weight layout
# ------------------------------------------------------------------------ #
def _attn(a: Arch) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    p = {"wq": ((a.d, a.heads, a.head_dim), BF16),
         "wk": ((a.d, a.kv_heads, a.head_dim), BF16),
         "wv": ((a.d, a.kv_heads, a.head_dim), BF16),
         "wo": ((a.heads, a.head_dim, a.d), BF16)}
    if a.qk_norm:
        p["q_norm"] = ((a.head_dim,), F32)
        p["k_norm"] = ((a.head_dim,), F32)
    return p


def _mlp(d: int, f: int) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    return {"w_gate": ((d, f), BF16), "w_up": ((d, f), BF16),
            "w_down": ((f, d), BF16)}


def _block(a: Arch) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    out = {"norm1": ((a.d,), F32), "norm2": ((a.d,), F32)}
    out.update({f"attn/{k}": v for k, v in _attn(a).items()})
    out.update({f"mlp/{k}": v for k, v in _mlp(a.d, a.d_ff).items()})
    return out


def layout(a: Arch) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(path, shape, dtype) of every leaf, sorted by path: the layers
    stacked under ``groups/0:global`` with a leading layer axis."""
    leaves = {"embedding/table": ((a.vocab_rows, a.d), BF16),
              "final_norm": ((a.d,), F32)}
    if not a.tied:
        leaves["embedding/lm_head"] = ((a.vocab_rows, a.d), BF16)
    for k, (shape, dt) in _block(a).items():
        leaves[f"groups/0:global/{k}"] = ((a.layers, *shape), dt)
    return sorted((p, s, dt) for p, (s, dt) in leaves.items())


# ------------------------------------------------------------------------ #
# the frozen yardstick
# ------------------------------------------------------------------------ #
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
    w = layout_bytes(layout(a))
    table = a.vocab_rows * a.d * BF16_BYTES
    if a.tied:
        w = w - table + a.vocab * a.d * BF16_BYTES
    else:
        w = w - table + len(ctx) * a.d * BF16_BYTES
        w = w - (a.vocab_rows - a.vocab) * a.d * BF16_BYTES  # lm_head's pad
    return w + a.kv_row_bytes * (sum(ctx) + len(ctx))


def attention_kernel_bytes(a: Arch, contexts: Iterable[int]) -> float:
    """Bytes one paged decode attention launch (one layer of K1) must
    move: each live slot's cached K/V rows of that layer once, its query
    read, its output written, and its new row read and committed."""
    ctx = list(contexts)
    row = 2 * a.kv_heads * a.head_dim * BF16_BYTES
    q = out = a.heads * a.head_dim * BF16_BYTES
    return row * sum(ctx) + len(ctx) * (q + out + 2 * row)
