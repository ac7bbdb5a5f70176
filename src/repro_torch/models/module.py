"""Minimal parameter-tree module system (port of ``repro/models/module.py``).

A model definition builds an abstract tree of :class:`Param` leaves (shape +
dtype + logical axis names + initializer); :func:`init_tree` turns it into
torch tensors. Every draw comes from one explicit ``torch.Generator``, in
the tree's sorted-path order, so a seed fixes the weights. The numbers differ
from the reference's (JAX and torch generators differ); tests that compare
the two packages load the reference's weights through ``models.bridge``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones | fan_in | embed
    scale: Optional[float] = None  # stddev override

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def _std(p: Param) -> float:
    """The reference's stddev rules (module.py `_init_leaf`), quirks kept: a
    stacked kernel's fan-in spans its leading layer axis too."""
    if p.init in ("embed", "normal"):
        return p.scale if p.scale is not None else 0.02
    fan = p.shape[0] if len(p.shape) == 1 else math.prod(p.shape[:-1])
    if p.logical[0] == "embed":
        fan = p.shape[0]
    return p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan, 1))


#: leaves above this many elements draw their fp32 normals a block of
#: leading-axis rows at a time (as many as fit this many elements, at least
#: one), so the fp32 temporary of a stacked expert tensor (5 GB per
#: deepseek-v2 MoE layer) never exists for all layers at once, and a wide
#: vocabulary's table takes a few draws, not one per row
CHUNKED_INIT_ELEMENTS = 2**30


def _init_leaf(gen: torch.Generator, p: Param, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    if p.init not in ("embed", "fan_in", "normal"):
        raise ValueError(f"unknown init {p.init}")
    std = _std(p)
    # the scale multiplies in place: one fp32 temporary, not two (a row of
    # grok-1's stacked experts is 6.4 GB of fp32)
    if p.size <= CHUNKED_INIT_ELEMENTS:
        x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(p.dtype)
    out = torch.empty(p.shape, dtype=p.dtype, device=device)
    rows = max(1, CHUNKED_INIT_ELEMENTS // out[0].numel())
    for block in out.split(rows):
        block.copy_(torch.randn(block.shape, generator=gen,
                                dtype=torch.float32, device=device).mul_(std))
    return out


def flatten(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, paths joined by "/", sorted."""
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from flatten(tree[k], path)
        else:
            yield path, tree[k]


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def init_tree(tree: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """Materialize a Param tree into tensors on `device` from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return unflatten({path: _init_leaf(gen, p, device)
                      for path, p in flatten(tree)})


def stack_params(tree: Dict[str, Any], n: int,
                 axis_name: Optional[str] = None) -> Dict[str, Any]:
    """Add a leading 'layers' axis to every Param (stacked layer weights)."""
    return {k: (stack_params(v, n, axis_name) if isinstance(v, dict) else
                Param((n, *v.shape), (axis_name, *v.logical), v.dtype,
                      v.init, v.scale))
            for k, v in tree.items()}


def count_params(tree: Dict[str, Any]) -> int:
    return sum(p.size for _, p in flatten(tree))
