"""deepseek-v2's gather dispatch on a 2x2 mesh at a capacity that drops.

Reduced deepseek at capacity factor 0.5: the prefill's 80 tokens route 160
slots into 8 experts of 16 places, the training step's micro-batches of
2 x 64 tokens 256 slots into 8 x 16, so at least a fifth of the slots
drop. Four spawned gloo
processes (``mesh_parity.run``), fp32 weights: prefill, a decode step and a
training step at accum 2 within ``mesh_parity.TOLERANCE`` of no mesh. A
drop that differed from the reference's global capacity (a dispatch run per
shard, say) moves a token's output by a whole expert's contribution.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.launch import mesh_parity as MP
from repro_torch.models import moe as MOE


def test_two_by_two_mesh_with_drops_holds_to_no_mesh():
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                              capacity_factor=0.5)
    assert MOE._capacity(cfg, 80) * cfg.num_experts < 80 * 2
    assert MOE._capacity(cfg, 128) * cfg.num_experts < 128 * 2
    errs = MP.run(cfg, cfg, device="cpu", mesh=(2, 2), prompt=40,
                  train_seq=64)
    assert len(errs) == 7 and all(v <= 1.0 for v in errs.values()), errs
