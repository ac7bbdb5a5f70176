"""Meshes wider than 1x1 compute what no mesh computes.

``repro_torch.launch.mesh_parity --mesh DxM`` spawns one gloo process per
rank (a ``FileStore`` in a temporary directory, no network) and runs a
reduced model with fp32 weights twice from the same inputs: without a mesh
and with parameters, batch and caches as DTensors laid out by the sharding
rules. There the routes that a 1x1 mesh never takes act: ``_project``'s
matmul and ``_heads_for_mesh``'s repeated kv heads (2 kv heads on a 4-way
model axis), the vocab-split lookup (``_SumLookup``) and the cross-entropy's
target logit by mask and sum, attention over a decode cache split over its
sequence (``write_rows``), ``pad_zeros``/``roll_rows`` on DTensors (gemma2's
window ring), MoE dispatch, and the micro-batches of the training step
gathered and split again (at accum 2, with loss masks that count different
tokens per row, and grok's aux loss). Prefill logits and caches, a decode
step's logits and caches, and a training step's new parameters, optimizer
state and metrics must hold at ``mesh_parity.TOLERANCE``.

deepseek-v2 is left out: its gather dispatch stops on a DTensor (ROADMAP
§3).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import mesh_parity as MP
from repro_torch.launch import steps as S

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch,mesh", [
    ("qwen3-1.7b", "1x4"), ("grok-1-314b", "2x2"), ("gemma2-27b", "2x2"),
    ("rwkv6-7b", "2x2")])
def test_wide_cpu_mesh_holds_to_no_mesh(arch, mesh):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mesh_parity", "--arch",
         arch, "--device", "cpu", "--reduced", "--mesh", mesh, "--prompt",
         "40"], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    errs = out["err_over_limit"]
    assert set(errs) == {"prefill_logits", "prefill_caches", "decode_logits",
                         "decode_caches", "train_params", "train_opt",
                         "train_metrics"}
    assert all(v <= 1.0 for v in errs.values()), errs


def test_micro_batches_are_contiguous_rows():
    """Without a mesh the cut is the reference's reshape: micro-batch i
    holds rows i * B / accum ... (i + 1) * B / accum - 1."""
    v = torch.arange(24).reshape(6, 4)
    parts = S._micro_batches(v, 3)
    assert len(parts) == 3
    for i, p in enumerate(parts):
        assert torch.equal(p, v[2 * i:2 * i + 2])


def test_uneven_loss_mask_counts_differ_between_micro_batches():
    m = MP.uneven_loss_mask(4, 16, "cpu")
    assert m.sum(1).tolist() == [16.0, 13.0, 10.0, 7.0]
    assert m[:2].sum() != m[2:].sum()


def test_tolerance_error_of_a_leaf():
    want = torch.tensor([1.0, -2.0, 0.5])
    assert MP.tol_err(want, want.clone()) == 0.0
    got = want + torch.tensor([0.0, 2e-4, 0.0])
    assert MP.tol_err(want, got) == pytest.approx(1.0, rel=1e-3)
    assert MP.tol_err(want, got * float("nan")) == float("inf")
    assert MP.tol_err(want, want[:2]) == float("inf")
    ints = torch.tensor([1, 2, 3])
    assert MP.tol_err(ints, ints.clone()) == 0.0
    assert MP.tol_err(ints, ints + 1) == float("inf")
