"""The port's data pipeline and fault runtime against the reference's.

``TokenPipeline``: for a seed and a step the port's batch equals the
reference's bit for bit (tokens, targets, loss mask, and the frontend
stub's bf16 embeddings), for steps 0-5 synchronously, through the prefetch
thread, after ``skip_to``, and from memory-mapped token files; the batch
lands on the pipeline's device. ``runtime.fault``: heartbeats, stragglers
and the rescale plan, as the reference's tests drive them.
"""
import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import TokenPipeline as RefTokenPipeline
from repro.runtime import fault as ref_fault
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.runtime.fault import HeartbeatMonitor, rescale_plan

CASES = {
    "lm": dict(global_batch=4, seq_len=32, vocab_size=1000, seed=7),
    "frontend": dict(global_batch=2, seq_len=16, vocab_size=256, seed=2,
                     frontend_tokens=4, d_model=64),
    "no-packing": dict(global_batch=3, seq_len=8, vocab_size=50, seed=1,
                       pack_docs=False),
}


def _np(v):
    """A batch leaf as numpy bits (bf16 as its uint16 patterns)."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    a = np.asarray(v)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_reference_bitwise(case):
    """Steps 0-5: synchronous, prefetched (distance 3) and after skip_to."""
    kw = CASES[case]
    ref = RefTokenPipeline(RefDataConfig(**kw))
    want = [ref._host_batch(s) for s in range(6)]
    sync = TokenPipeline(DataConfig(**kw), device="cpu")
    for s in range(6):
        _same(next(sync), want[s])
    pre = TokenPipeline(DataConfig(**kw, prefetch_distance=3), device="cpu")
    pre.start()
    try:
        for s in range(6):
            _same(next(pre), want[s])
            assert pre.step == s + 1
    finally:
        pre.stop()
    assert not pre._thread.is_alive()
    skip = TokenPipeline(DataConfig(**kw), device="cpu")
    skip.skip_to(3)
    skip.start()
    try:
        for s in range(3, 6):
            _same(next(skip), want[s])
    finally:
        skip.stop()


def test_batches_from_token_files_equal_reference(tmp_path):
    rng = np.random.default_rng(0)
    files = []
    for i in range(2):
        f = tmp_path / f"shard{i}.npy"
        np.save(f, rng.integers(0, 500, 4096).astype(np.int32))
        files.append(str(f))
    kw = dict(global_batch=2, seq_len=64, vocab_size=500, seed=3,
              token_files=tuple(files))
    ref = RefTokenPipeline(RefDataConfig(**kw))
    port = TokenPipeline(DataConfig(**kw), device="cpu")
    for s in range(4):
        _same(next(port), ref._host_batch(s))


def test_batch_contract():
    """Types and shapes; targets are the next tokens; the same seed and
    step give the same batch; skip_to after start raises."""
    p = TokenPipeline(DataConfig(**CASES["frontend"]), device="cpu")
    b = next(p)
    assert b["tokens"].dtype == torch.int32 and b["targets"].dtype == torch.int32
    assert b["loss_mask"].dtype == torch.float32
    assert b["frontend_embeds"].dtype == torch.bfloat16
    assert b["frontend_embeds"].shape == (2, 4, 64)
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    again = TokenPipeline(DataConfig(**CASES["frontend"]), device="cpu")
    _same(next(again), b)
    p.start()
    with pytest.raises(RuntimeError):
        p.skip_to(0)
    p.stop()


def test_pipeline_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TokenPipeline(DataConfig(**CASES["lm"]))


# ------------------------------------------------------------------ fault
def test_heartbeat_dead_worker_detection():
    for hb in (HeartbeatMonitor(deadline_s=10),
               ref_fault.HeartbeatMonitor(deadline_s=10)):
        hb.beat("a", now=0.0)
        hb.beat("b", now=0.0)
        hb.beat("a", now=8.0)
        assert hb.dead_workers(now=12.0) == ["b"]


def test_straggler_detection():
    got, want = HeartbeatMonitor(), ref_fault.HeartbeatMonitor()
    rng = np.random.default_rng(0)
    for i in range(16):
        for w in ("a", "b", "c", "d"):
            t = 1.0 + (3.0 if w == "c" else 0.0) + 0.01 * rng.random()
            got.beat(w, step_time=t, now=float(i))
            want.beat(w, step_time=t, now=float(i))
    assert got.stragglers() == want.stragglers() == ["c"]
    assert got.stragglers(min_samples=32) == []


def test_rescale_plan():
    for old, new in ((2, 1), (1, 2), (4, 3)):
        got, want = rescale_plan(old, new), ref_fault.rescale_plan(old, new)
        assert (got.old_mesh, got.new_mesh, got.new_axes, got.batch_scale,
                got.action) == (want.old_mesh, want.new_mesh, want.new_axes,
                                want.batch_scale, want.action)
    assert rescale_plan(2, 1).new_mesh == (16, 16)
    assert rescale_plan(2, 1).batch_scale == 2.0
    assert rescale_plan(1, 2).new_mesh == (2, 16, 16)
    with pytest.raises(ValueError):
        rescale_plan(2, 0)
