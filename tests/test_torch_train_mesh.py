"""The trainer over a mesh (``launch.train --mesh DxM``) against the
one-device trainer.

A 1x1 mesh (a one-rank gloo group that the trainer opens itself) takes no
route that splits a dim, so its losses and final state equal the one-device
run's bit for bit. A 2x2 mesh runs as four spawned gloo processes, each
calling ``train.main`` inside a group the spawner opened (a ``FileStore``
in a temporary directory, no network), on reduced qwen3 with fp32 weights
and AdamW's eps at ``mesh_parity.WIDE_MESH_EPS``: its sums over split dims
round in another order, so it is held at ``mesh_parity.TOLERANCE``. Its
checkpoints are the one-device format: a 2x2 run resumed from its step-2
checkpoint ends where the uninterrupted run ends, and its checkpoint
restores leaf for leaf into the one-device trainer's state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import shutil

import pytest
import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import mesh_parity as MP
from repro_torch.launch import train
from repro_torch.launch.mesh import one_rank_mesh
from repro_torch.models import module as M
from repro_torch.runtime.sharding import distribute_tree, is_dtensor, whole

CFG = get_config("qwen3-1.7b").reduced()
STEPS = 3
ARGS = ["--steps", str(STEPS), "--batch", "4", "--seq", "32",
        "--log-every", "1", "--device", "cpu"]


@contextlib.contextmanager
def fp32_weights():
    """The trainer's init cast to fp32 and AdamW's eps at WIDE_MESH_EPS
    (what ``mesh_parity`` runs a wide mesh with)."""
    init, opt = train.init_params, train.OptimizerConfig

    def init_f32(cfg, **kw):
        return M.map_leaves(lambda t: t.float(), init(cfg, **kw))

    train.init_params = init_f32
    train.OptimizerConfig = functools.partial(opt, eps=MP.WIDE_MESH_EPS)
    try:
        yield
    finally:
        train.init_params, train.OptimizerConfig = init, opt


def _whole_state(out):
    return {key: M.map_leaves(whole, out[key])
            for key in ("params", "opt_state")}


def _rank_main(rank, world, store, result, ckpt):
    """One rank of the 2x2 runs: uninterrupted with a checkpoint every 2
    steps, resumed from step 2 after rank 0 removes the last checkpoint,
    and with the remat carry split over the sequence (seq_shard_carry)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        argv = ARGS + ["--mesh", "2x2"]
        out = {}
        with fp32_weights():
            full = train.main(argv + ["--ckpt-dir", ckpt, "--ckpt-every",
                                      "2"], cfg=CFG)
            out["full"] = dict(_whole_state(full), losses=full["losses"],
                               start=full["start"])
            dist.barrier()
            if rank == 0:
                shutil.copytree(ckpt, ckpt + "_final")
                shutil.rmtree(os.path.join(ckpt, f"step_{STEPS:08d}"))
            dist.barrier()
            res = train.main(argv + ["--ckpt-dir", ckpt], cfg=CFG)
            out["resumed"] = dict(_whole_state(res), losses=res["losses"],
                                  start=res["start"])
            carry = train.main(argv, cfg=dataclasses.replace(
                CFG, seq_shard_carry=True))
            out["carry"] = dict(_whole_state(carry), losses=carry["losses"])
        if rank == 0:
            torch.save(out, result)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("train_mesh")
    result, ckpt = str(d / "result.pt"), str(d / "ckpt")
    mp.spawn(_rank_main, nprocs=4, join=True,
             args=(4, str(d / "store"), result, ckpt))
    with fp32_weights():
        one = train.main(list(ARGS), cfg=CFG)
    return {"one": dict(_whole_state(one), losses=one["losses"]),
            "ckpt": ckpt + "_final", **torch.load(result)}


def _tol(want, got) -> float:
    return max(MP.tree_diff(want[k], got[k], MP.tol_err)
               for k in ("params", "opt_state"))


def test_one_by_one_mesh_trains_bitwise_as_one_device():
    one = train.main(list(ARGS), cfg=CFG)
    mesh = train.main(ARGS + ["--mesh", "1x1"], cfg=CFG)
    assert len(one["losses"]) == STEPS
    assert mesh["losses"] == one["losses"]          # loss by loss, exactly
    for key in ("params", "opt_state"):
        assert MP.tree_diff(one[key], mesh[key]) == 0, key
        assert not any(is_dtensor(v) for _, v in M.flatten(mesh[key]))


def test_one_by_one_mesh_resume_equals_uninterrupted(tmp_path):
    argv = ARGS + ["--mesh", "1x1", "--ckpt-dir", str(tmp_path),
                   "--ckpt-every", "2"]
    full = train.main(argv, cfg=CFG)
    shutil.rmtree(tmp_path / f"step_{STEPS:08d}")
    res = train.main(argv, cfg=CFG)
    assert (full["start"], res["start"]) == (0, 2)
    assert res["losses"] == full["losses"][2:]
    for key in ("params", "opt_state"):
        assert MP.tree_diff(full[key], res[key]) == 0, key


@pytest.mark.parametrize("run", ["full", "carry"])
def test_two_by_two_mesh_holds_to_one_device(wide, run):
    """Every step's loss and the final parameters and AdamW state within
    mesh_parity.TOLERANCE of the one-device run (fp32 weights); "carry"
    runs with the remat carry split over the sequence on the model axis."""
    want, got = wide["one"], wide[run]
    assert len(got["losses"]) == STEPS
    for a, b in zip(want["losses"], got["losses"]):
        assert abs(a - b) <= MP.TOLERANCE[torch.float32] * abs(a)
    assert _tol(want, got) <= 1.0


def test_two_by_two_resume_equals_uninterrupted(wide):
    full, res = wide["full"], wide["resumed"]
    assert (full["start"], res["start"]) == (0, 2)
    assert res["losses"] == full["losses"][2:]
    for key in ("params", "opt_state"):
        assert MP.tree_diff(full[key], res[key]) == 0, key


def test_two_by_two_checkpoint_restores_into_one_device_state(wide):
    """The 2x2 run's last checkpoint, restored with the one-device state as
    `like`, gives that run's final state leaf for leaf, as plain tensors."""
    like = (wide["one"]["params"], wide["one"]["opt_state"])
    step, (params, opt) = CheckpointManager(CheckpointConfig(
        wide["ckpt"])).restore(like=like, device="cpu")
    assert step == STEPS
    assert MP.tree_diff(wide["full"]["params"], params) == 0
    assert MP.tree_diff(wide["full"]["opt_state"], opt) == 0
    assert not any(is_dtensor(v) for _, v in M.flatten(params))


def test_restore_lays_leaves_out_by_like_and_by_shardings(tmp_path):
    """On a 1x1 gloo mesh: a one-device checkpoint restored into DTensor
    `like` leaves takes their mesh and placements; `shardings` (a tree of
    Layout) overrides plain `like` leaves; the values are the saved bits."""
    from torch.distributed.tensor import Replicate

    from repro_torch.checkpoint import Layout

    state = {"a": torch.arange(6.0).reshape(2, 3),
             "b": torch.ones(4, dtype=torch.bfloat16)}
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
    mgr.save(1, state, block=True)
    with one_rank_mesh("cpu") as mesh:
        like = distribute_tree(state, {"a": [Replicate()] * 2,
                                          "b": [Replicate()] * 2}, mesh)
        _, got = mgr.restore(like=like, device="cpu")
        assert all(is_dtensor(v) for v in got.values())
        assert got["a"].device_mesh is mesh
        _, got2 = mgr.restore(like=state, device="cpu", shardings={
            "a": Layout(mesh, (Replicate(), Replicate())), "b": None})
        assert is_dtensor(got2["a"]) and not is_dtensor(got2["b"])
        for tree in (got, got2):
            for k in state:
                assert MP.bit_diff(state[k], whole(tree[k])) == 0


def test_mesh_needs_its_world_size():
    with pytest.raises(ValueError, match="needs 4 rank"):
        train.main(ARGS + ["--mesh", "2x2"], cfg=CFG)
    with one_rank_mesh("cpu"):
        with pytest.raises(ValueError, match="the process group has 1"):
            train.main(ARGS + ["--mesh", "2x2"], cfg=CFG)
    with pytest.raises(ValueError, match="DATAxMODEL"):
        train.main(ARGS + ["--mesh", "2by2"], cfg=CFG)
