"""The weights of a run, made on the device from ``--seed``.

The tree has the port's layout (its parameter tree's paths and shapes;
``tests/test_pulbench_specs.py`` holds the two to each other on the CPU).
Every leaf is a view into one of two flat buffers, one bf16 and one fp32,
each filled by a few large ``normal_`` calls of one ``torch.Generator`` on
the device: N(0, initializer_range) for every weight and the
norms' scale offsets (the port's norms multiply by 1 + scale). The same
tensors go to the port and to the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from pulbench.spec import Arch

BF16, F32 = "bf16", "f32"
#: elements a single normal_ call fills (two calls for 3.4 GB)
DRAW_ELEMENTS = 2**30


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


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def make(a: Arch, seed: int, device) -> Dict[str, Any]:
    """The weight tree from `seed`, every leaf a view of one of two flat
    buffers drawn on `device` (bf16 and fp32), N(0, initializer_range)."""
    leaves = layout(a)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    flat: Dict[str, torch.Tensor] = {}
    for dt, torch_dt in ((BF16, torch.bfloat16), (F32, torch.float32)):
        mine = [(p, s) for p, s, d in leaves if d == dt]
        total = sum(math.prod(s) for _, s in mine)
        buf = torch.empty(total, dtype=torch_dt, device=device)
        for block in buf.split(DRAW_ELEMENTS):
            block.normal_(0.0, a.init_std, generator=gen)
        off = 0
        for p, s in mine:
            n = math.prod(s)
            flat[p] = buf[off:off + n].view(s)
            off += n
    return _unflatten(flat)


def nbytes(a: Arch) -> int:
    return sum(math.prod(s) * (2 if dt == BF16 else 4)
               for _, s, dt in layout(a))
