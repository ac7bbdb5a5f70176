"""The port's checkpoints and trainer against the reference's.

``CheckpointManager``: the round trip (bf16 leaves as uint16 bits) and
the ``keep`` GC; an async flush that fails is re-raised by ``wait()``; the
snapshot is a copy (training on after ``save`` returns does not change
what is written); restart-continuation: 2 steps, a checkpoint, a restore
and 2 more steps equal 4 uninterrupted steps bitwise; a checkpoint
written by the reference restores in the port and the reverse, leaf for
leaf (both number the leaves in JAX's pytree order: dict keys sorted,
tuple items in order, so ``leaf_i`` names the same tensor in both).
``launch.train.main`` in process: 6 steps with a checkpoint every 3, then
a rerun that resumes (the port's passing counterpart of the reference's
``test_trainer_cli_runs_and_resumes``), a run stopped after step 3 and
resumed to step 6 that ends bitwise where the uninterrupted run ends, and
``--mesh``, which is not ported and raises. ``examples.train_lm``'s
``small_100m`` equals the reference's configuration.
"""
import dataclasses
import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as RefCheckpointConfig
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.checkpoint.checkpoint import flatten_state
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.examples.train_lm import small_100m
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.models import module as M
from repro_torch.models.bridge import opt_state_from_reference
from repro_torch.optim import OptimizerConfig, adamw_init
from test_torch_ssm import _flat
from test_torch_train_grads import train_pair

ROOT = Path(__file__).resolve().parent.parent


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), keep=2))
    state = {"w": torch.arange(8, dtype=torch.float32),
             "n": {"v": torch.ones((2, 2), dtype=torch.bfloat16),
                   "i": torch.tensor(3, dtype=torch.int32)}}
    for s in (10, 20, 30):
        mgr.save(s, {"w": state["w"] * s,
                     "n": {"v": state["n"]["v"] * s, "i": state["n"]["i"]}})
    mgr.wait()
    assert mgr.latest_step() == 30
    step, restored = mgr.restore(like=state, device="cpu")
    assert step == 30
    assert torch.equal(restored["w"], torch.arange(8) * 30.0)
    assert restored["n"]["v"].dtype == torch.bfloat16
    assert torch.equal(restored["n"]["v"], state["n"]["v"] * 30)
    assert restored["n"]["i"].dtype == torch.int32 and int(restored["n"]["i"]) == 3
    assert mgr._steps() == [20, 30]                 # keep=2 collected 10
    assert sorted(p.name for p in (tmp_path / "step_00000030").iterdir()) \
        == ["manifest.json", "shard_0.npz"]
    step, older = mgr.restore(20, like=state, device="cpu")
    assert step == 20 and torch.equal(older["w"], torch.arange(8) * 20.0)


def test_async_flush_failure_is_reraised_by_wait(tmp_path):
    """save() returns after its snapshot; a flush that then fails (here:
    the checkpoint directory replaced by a file) raises from wait(), once."""
    d = tmp_path / "ck"
    mgr = CheckpointManager(CheckpointConfig(str(d)))
    shutil.rmtree(d)
    d.write_text("not a directory")
    mgr.save(1, {"w": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="async checkpoint flush failed"):
        mgr.wait()
    mgr.wait()                                       # the error was consumed
    with pytest.raises(RuntimeError, match="flush failed"):
        mgr.save(2, {"w": torch.zeros(4)}, block=True)


def test_snapshot_is_a_copy(tmp_path):
    """What save() writes is the state at the call, even when the caller
    overwrites the tensors in place before the flush runs."""
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
    w = torch.ones(1 << 16)
    mgr.save(1, {"w": w})
    w.zero_()
    mgr.wait()
    _, got = mgr.restore(like={"w": w}, device="cpu")
    assert torch.equal(got["w"], torch.ones(1 << 16))


def test_checkpoint_restart_continuation(tmp_path):
    """Kill and restart gives the state of an uninterrupted run, bitwise
    (reduced qwen3-1.7b, the port's own init, 4 steps vs 2 + restore + 2)."""
    cfg = get_config("qwen3-1.7b").reduced()
    step_fn = make_train_step(cfg, OptimizerConfig(lr=1e-3))
    dcfg = DataConfig(global_batch=2, seq_len=16, vocab_size=cfg.vocab_size,
                      seed=5)

    def run(n_steps, params, opt, start=0):
        data = TokenPipeline(dcfg, device="cpu")
        data.skip_to(start)
        for _ in range(start, n_steps):
            params, opt, _ = step_fn(params, opt, next(data))
        return params, opt

    p0 = init_params(cfg, seed=0, device="cpu")
    o0 = adamw_init(p0)
    p_full, o_full = run(4, p0, o0)
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
    p2, o2 = run(2, p0, o0)
    mgr.save(2, (p2, o2), block=True)
    step, (p2r, o2r) = mgr.restore(like=(p2, o2), device="cpu")
    assert step == 2
    p_res, o_res = run(4, p2r, o2r, start=step)
    for (path, a), (_, b) in zip(M.flatten(p_full), M.flatten(p_res)):
        assert torch.equal(a, b), path
    for (path, a), (_, b) in zip(M.flatten(o_full["m"]), M.flatten(o_res["m"])):
        assert torch.equal(a, b), path
    assert int(o_res["step"]) == 4


def _pair_state(moments):
    """The bridged reduced qwen3 with an optimizer state of random moments
    in `moments` (fp32 or bf16) and step 7, on both sides."""
    _, ref_params, cfg, params = train_pair("qwen3-1.7b", False)
    jdt, tdt = ((jnp.float32, torch.float32) if moments == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(1)
    ref_opt = ref_adamw_init(ref_params, jdt)
    ref_opt = {k: (jax.tree.map(lambda z: jnp.asarray(
        rng.standard_normal(z.shape), jnp.float32).astype(jdt), ref_opt[k])
                   if k != "step" else jnp.int32(7)) for k in ref_opt}
    opt = opt_state_from_reference(_flat(ref_opt["m"]), _flat(ref_opt["v"]),
                                   7, cfg, moment_dtype=tdt, device="cpu")
    return (ref_params, ref_opt), (params, opt)


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def _torch_bits(t):
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, moments):
    ref_state, state = _pair_state(moments)
    ref_mgr = RefCheckpointManager(RefCheckpointConfig(str(tmp_path)))
    ref_mgr.save(7, ref_state, block=True)
    step, got = CheckpointManager(CheckpointConfig(str(tmp_path))).restore(
        like=state, device="cpu")
    assert step == 7
    want_leaves = jax.tree.leaves(ref_state)
    got_leaves = flatten_state(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(_torch_bits(g), _bits(w))
    # and by name: the port's tree holds the reference's values
    for path, t in M.flatten(got[0]):
        np.testing.assert_array_equal(t.float().numpy(),
                                      _flat(ref_state[0])[path], err_msg=path)
    assert int(got[1]["step"]) == 7 and got[1]["step"].dtype == torch.int32


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, moments):
    ref_state, state = _pair_state(moments)
    CheckpointManager(CheckpointConfig(str(tmp_path))).save(7, state,
                                                            block=True)
    step, got = RefCheckpointManager(RefCheckpointConfig(
        str(tmp_path))).restore(like=ref_state)
    assert step == 7
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(ref_state)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


# ---------------------------------------------------------------- trainer
ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "6", "--batch", "2",
        "--seq", "16", "--ckpt-every", "3", "--log-every", "2",
        "--device", "cpu"]


def test_trainer_cli_runs_and_resumes(tmp_path, capsys):
    out1 = train_cli.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "[train] step 1 loss" in text and "[train] step 6 loss" in text
    assert "[train] done; final loss" in text and out1["start"] == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000006"]
    out2 = train_cli.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "[train] resumed from step 6" in text and out2["start"] == 6
    assert "final loss n/a" in text
    for (path, a), (_, b) in zip(M.flatten(out1["params"]),
                                 M.flatten(out2["params"])):
        assert torch.equal(a, b), path


def test_trainer_resumed_run_equals_uninterrupted(tmp_path, capsys):
    """A run that lost its last checkpoint (as a crash after step 3 would
    leave it) and is rerun resumes from its step-3 checkpoint and ends
    where the uninterrupted 6 steps ended, bitwise."""
    full = train_cli.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    shutil.rmtree(tmp_path / "step_00000006")
    capsys.readouterr()
    resumed = train_cli.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    assert "resumed from step 3" in capsys.readouterr().out
    assert resumed["start"] == 3 and resumed["loss"] == full["loss"]
    for (path, a), (_, b) in zip(M.flatten(full["params"]),
                                 M.flatten(resumed["params"])):
        assert torch.equal(a, b), path
    for (path, a), (_, b) in zip(M.flatten(full["opt_state"]),
                                 M.flatten(resumed["opt_state"])):
        assert torch.equal(a, b), path


def test_trainer_mesh_is_not_ported():
    """--mesh is ported (tests/test_torch_train_mesh.py); a lone process
    without a process group cannot hold a 2x4 mesh and says so."""
    with pytest.raises(ValueError, match="needs 8 rank"):
        train_cli.main(ARGS + ["--mesh", "2x4"])


def _reference_train_lm():
    spec = importlib.util.spec_from_file_location(
        "reference_train_lm", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b", "zamba2-7b",
                                  "deepseek-v2-236b", "musicgen-large"])
def test_small_100m_equals_reference(arch):
    want = dataclasses.asdict(_reference_train_lm().small_100m(arch))
    got = dataclasses.asdict(small_100m(arch))
    assert got == want
