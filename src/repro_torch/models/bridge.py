"""Load the reference package's parameters into the port.

The reference keeps parameters as a JAX tree; a test flattens it by path
("groups/0:global/attn/wq", ...) into float32 numpy arrays on the JAX side
(bf16 -> float32 is exact, so the port needs no bf16 numpy type). This
module turns that flat dict into the port's parameter tree, each leaf cast
to the dtype the port's tree declares (bf16 weights, fp32 norms).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import module as M
from repro_torch.models import transformer as T


def params_from_reference(flat: Dict[str, np.ndarray], cfg: ModelConfig, *,
                          device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    spec = dict(M.flatten(T.model_params(cfg)))
    if set(flat) != set(spec):
        raise KeyError(f"reference params differ from the port's tree: "
                       f"missing {sorted(set(spec) - set(flat))}, "
                       f"extra {sorted(set(flat) - set(spec))}")
    out = {}
    for path, p in spec.items():
        arr = np.asarray(flat[path])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected {p.shape}")
        out[path] = torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=p.dtype)
    return M.unflatten(out)
