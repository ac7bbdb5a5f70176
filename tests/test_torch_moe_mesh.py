"""deepseek-v2's gather dispatch on a mesh (``moe._moe_gather``).

DTensor has no layout for the dispatch's sort, inverse permutation and
slot-table writes, so on a mesh the routing integers and the rows they
gather are made whole on every device and the dispatch runs on local
tensors. That keeps the reference's global capacity over all T * k routed
slots, its stable ranking by expert and its drops, whatever the mesh:

  * the kept slots equal the reference's ``_moe_gather`` on the same routed
    ids at capacities that drop (the expert FFN an identity and the weight
    of the kth slot 2^k, so each token's output is the bit mask of its kept
    slots);
  * reduced deepseek on a 1x1 gloo mesh differs from no mesh in 0 elements
    in prefill, decode and a training step (before, it stopped at the
    slot table's ``index_put_``);
  * on a 1x4 mesh of four spawned gloo processes, with fp32 weights, every
    step within ``mesh_parity.TOLERANCE`` of no mesh
    (``test_torch_moe_mesh_drops.py`` runs a 2x2 mesh at a capacity that
    drops).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.launch import mesh_parity as MP
from repro_torch.models import moe as MOE

ARCH = "deepseek-v2-236b"


def _skewed_ids(T: int, k: int, E: int, seed: int) -> np.ndarray:
    """(T, k) distinct experts per token, drawn with weights 1/(e + 1), so
    the first experts overflow."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, E + 1)
    p /= p.sum()
    return np.stack([rng.choice(E, size=k, replace=False, p=p)
                     for _ in range(T)]).astype(np.int32)


@pytest.mark.parametrize("T,k,E,cf", [
    (64, 2, 8, 0.5), (200, 6, 16, 0.25), (37, 2, 4, 1.0), (96, 2, 8, 1.25)])
def test_gather_keeps_the_reference_slots(monkeypatch, T, k, E, cf):
    ids = _skewed_ids(T, k, E, seed=T)
    w = np.tile(2.0 ** np.arange(k, dtype=np.float32), (T, 1))
    over = dict(num_experts=E, experts_per_tok=k, capacity_factor=cf)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **over)
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), **over)
    assert MOE._capacity(cfg, T) == ref_moe._capacity(ref_cfg, T)
    monkeypatch.setattr(ref_moe, "_route", lambda p, x, c: (
        jnp.asarray(ids), jnp.asarray(w), jnp.float32(0.0)))
    monkeypatch.setattr(ref_moe, "_expert_ffn", lambda p, h, c: h)
    monkeypatch.setattr(MOE, "_route", lambda p, x, c: (
        torch.from_numpy(ids).long(), torch.from_numpy(w), torch.zeros(())))
    monkeypatch.setattr(MOE, "_expert_ffn", lambda p, h, c: h)
    want, _ = ref_moe._moe_gather({}, jnp.ones((T, 1), jnp.float32), ref_cfg)
    got, _ = MOE._moe_gather({}, torch.ones(T, 1), cfg)
    want = np.asarray(want)[:, 0].astype(np.int64)
    assert np.array_equal(got[:, 0].long().numpy(), want)
    full = 2 ** k - 1
    if cf < 1.0:
        assert (want != full).any()                  # the capacity drops
    # the port's own table names the same kept slots
    rank, table = MOE._slot_table(torch.from_numpy(ids).reshape(-1).long(),
                                  T, k, E, MOE._capacity(cfg, T))
    kept = table[table < T * k]
    mask = torch.zeros(T, dtype=torch.long).index_add_(
        0, kept // k, 2 ** (kept % k))
    assert np.array_equal(mask.numpy(), want)
    assert int((rank < MOE._capacity(cfg, T)).sum()) == kept.numel()


def test_one_by_one_mesh_is_bitwise_no_mesh():
    """Prefill, a decode step and a training step at accum 2 (mesh_parity
    on a one-rank gloo group, in process)."""
    cfg = get_config(ARCH).reduced()
    diffs = MP.run(cfg, cfg, device="cpu", mesh=(1, 1), prompt=40)
    assert set(diffs) == {"prefill_logits", "prefill_caches",
                          "decode_logits", "decode_caches", "train_params",
                          "train_opt", "train_metrics"}
    assert all(v == 0 for v in diffs.values()), diffs


def test_one_by_four_mesh_holds_to_no_mesh():
    """Experts split four ways over the model axis, fp32 weights."""
    cfg = get_config(ARCH).reduced()
    errs = MP.run(cfg, cfg, device="cpu", mesh=(1, 4), prompt=40,
                  train_seq=64)
    assert len(errs) == 7 and all(v <= 1.0 for v in errs.values()), errs
