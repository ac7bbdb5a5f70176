"""The weights of a run, made on the device from ``--seed``.

The tree has the port's layout (its parameter tree's paths and shapes),
which the configuration's family gives (``families/<family>.py``;
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

from pulbench import families
from pulbench.families import BF16, F32

#: elements a single normal_ call fills (two calls for 3.4 GB)
DRAW_ELEMENTS = 2**30


def layout(a) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(path, shape, dtype) of every leaf of `a`'s family, sorted by path
    (``families/<family>.py``)."""
    return families.family(a.family).layout(a)


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def make(a, seed: int, device) -> Dict[str, Any]:
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


def nbytes(a) -> int:
    return families.layout_bytes(layout(a))
