"""build_model(config): the port's model entry point (``repro/models/zoo.py``).

A :class:`Model` binds a config to its parameters and exposes the entry
points the serving engines call: ``prefill``, ``decode_step`` (dense caches)
and ``paged_decode_step``, and the training loss, ``loss``.
:func:`input_specs` gives a dry-run cell's abstract inputs (meta tensors,
nothing allocated) and their logical axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import module as M
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    params: Dict[str, Any]        # nested dict of tensors (see model_params)

    def loss(self, batch):
        """The training loss on `batch`; see transformer.loss_fn."""
        return T.loss_fn(self.params, batch, cfg=self.cfg)

    def num_params(self) -> int:
        return M.count_params(T.model_params(self.cfg))

    def abstract_params(self):
        """The parameter tree as meta tensors (nothing allocated)."""
        return M.abstract_tree(T.model_params(self.cfg))

    def cache_specs(self, batch: int, max_seq: int):
        """(decode-cache tree of (shape, dtype) leaves, its logical axes),
        the reference's pair."""
        return (T.cache_specs(self.cfg, batch, max_seq),
                T.cache_logical(self.cfg))

    def prefill(self, tokens, lengths=None, max_seq: Optional[int] = None,
                frontend_embeds=None):
        """(B, T) tokens [after a (B, Tf, D) frontend prefix] -> (logits
        (B, V), caches); see prefill_fn."""
        return T.prefill_fn(self.params, tokens, lengths, cfg=self.cfg,
                            max_seq=max_seq, frontend_embeds=frontend_embeds)

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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """{"batch": tree, "batch_logical": tree[, "caches",
    "caches_logical"]} for one (arch x shape) cell, every leaf a meta
    tensor (reference ``zoo.input_specs``).

    The modality frontend stub shows here: internvl2 receives its
    precomputed ViT patch embeddings, musicgen its conditioning frames
    (cfg.frontend_tokens), and the token count shrinks so the whole
    sequence stays shape.seq_len."""
    B, S = shape.global_batch, shape.seq_len
    Tf = cfg.frontend_tokens if cfg.frontend else 0
    St = S - Tf
    out: Dict[str, Any] = {}
    if shape.kind == "train":
        batch = {"tokens": _meta((B, St), torch.int32),
                 "targets": _meta((B, St), torch.int32),
                 "loss_mask": _meta((B, St), torch.float32)}
        logical = {"tokens": ("batch", "seq"), "targets": ("batch", "seq"),
                   "loss_mask": ("batch", "seq")}
    elif shape.kind == "prefill":
        batch = {"tokens": _meta((B, St), torch.int32)}
        logical = {"tokens": ("batch", "seq")}
    elif shape.kind == "decode":
        batch = {"tokens": _meta((B, 1), torch.int32),
                 "pos0": _meta((B,), torch.int32)}
        logical = {"tokens": ("batch", None), "pos0": ("batch",)}
        spec = T.cache_specs(cfg, B, S)
        out["caches"] = M.map_leaves(lambda sd: _meta(*sd), spec)
        out["caches_logical"] = T.cache_logical(cfg)
    else:
        raise ValueError(shape.kind)
    if Tf and shape.kind != "decode":
        batch["frontend_embeds"] = _meta((B, Tf, cfg.d_model), torch.bfloat16)
        logical["frontend_embeds"] = ("batch", "seq", None)
    out["batch"] = batch
    out["batch_logical"] = logical
    return out


def demo_batch(cfg: ModelConfig, batch_size: int, seq_len: int, *,
               seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """A small concrete training batch (reference ``demo_batch``): uniform
    tokens, targets the tokens rolled by one, a full loss mask, and the
    frontend stub's bf16 embeddings (normal x 0.02) where the config has a
    frontend. Drawn from a ``torch.Generator`` seeded with `seed`: the
    numbers differ from the reference's, so tests hand both packages one
    numpy batch."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                           generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1),
             "loss_mask": torch.ones((batch_size, seq_len))}
    if cfg.frontend and cfg.frontend_tokens:
        batch["frontend_embeds"] = (torch.randn(
            (batch_size, cfg.frontend_tokens, cfg.d_model),
            generator=gen).to(torch.bfloat16) * 0.02)
    return {k: v.to(dev) for k, v in batch.items()}
