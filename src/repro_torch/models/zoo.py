"""build_model(config): the port's model entry point (``repro/models/zoo.py``).

A :class:`Model` binds a config to its parameters and exposes the entry
points the serving engines call: ``prefill``, ``decode_step`` (dense caches)
and ``paged_decode_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import module as M
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    params: Dict[str, Any]        # nested dict of tensors (see model_params)

    def prefill(self, tokens, lengths=None, max_seq: Optional[int] = None):
        """(B, T) tokens -> (logits (B, V), caches); see prefill_fn."""
        return T.prefill_fn(self.params, tokens, lengths, cfg=self.cfg,
                            max_seq=max_seq)

    def decode_step(self, batch, caches):
        """One dense decode step; see transformer.decode_fn."""
        return T.decode_fn(self.params, batch, caches, cfg=self.cfg)

    def paged_decode_step(self, batch, caches=None, planes=None, *,
                          pul_distance: int = 4):
        """One paged decode step; see transformer.paged_decode_fn."""
        return T.paged_decode_fn(self.params, batch, caches, planes,
                                 cfg=self.cfg, pul_distance=pul_distance)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random parameters from `seed` (the port's own init; reference rules)."""
    return M.init_tree(T.model_params(cfg), seed, resolve_device(device))


def build_model(cfg: ModelConfig, params: Optional[Dict[str, Any]] = None, *,
                seed: int = 0, device="cuda") -> Model:
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    return Model(cfg, params)
