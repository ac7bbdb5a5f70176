"""The paged decode step can be captured as one CUDA graph: a CPU guard.

``serving.capture.StepGuard`` watches every aten op of the engine's decode
step (its device half, ``PagedServingEngine._device_step``) for reduced
qwen3 (K1 sweep, K2 per layer) and reduced deepseek-v2 (K3, K4) on the CPU.
The step must read nothing back to the host (``.item()``, ``nonzero``,
``masked_select``, ``unique``), make no tensor from host data, copy nothing
between devices and read only its fixed inputs (the weights, the planes and
the step buffer), and it must run the same ops whatever the slots' lengths:
what a graph captured once can replay every tick. The guard itself is held
to reject each of those faults. On the card, ``tests/test_torch_cuda.py``
holds the captured step bitwise to the eager one.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving import PagedEngineConfig, PagedServingEngine, Request
from repro_torch.serving.capture import StepGuard, StepNotCapturable

ARCHS = {"qwen3": "qwen3-1.7b", "deepseek": "deepseek-v2-236b"}


def _guarded_engine(arch, sweep):
    """A reduced engine whose every decode step runs under a StepGuard;
    returns (engine, the guards by step)."""
    cfg = get_config(ARCHS[arch]).reduced()
    eng = PagedServingEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                             PagedEngineConfig(
                                 batch_slots=3, max_seq=64, page_tokens=8,
                                 prefill_buckets=(8, 16, 32),
                                 sweep_decode=sweep, device="cpu"))
    guards = []
    step = eng._device_step

    def guarded():
        guard = StepGuard(eng.device, eng.step_inputs())
        guards.append(guard)
        with guard:
            return step()

    eng._device_step = guarded
    return eng, guards


@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "per-layer"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_step_is_capturable(arch, sweep):
    """Every decode step of a script whose slots change length and
    occupancy (one slot finishes early, another is admitted later) passes
    the guard with one fixed op sequence."""
    eng, guards = _guarded_engine(arch, sweep)
    rng = np.random.default_rng(3)
    for rid, (n, new) in enumerate(((5, 6), (13, 2), (20, 5), (9, 4))):
        eng.submit(Request(rid=rid, prompt=rng.integers(1, 256, n).tolist(),
                           max_new_tokens=new))
    out = eng.run()
    assert all(len(out[r]) == n for r, n in enumerate((6, 2, 5, 4)))
    assert len(guards) == eng.metrics.decode_steps >= 5
    ops = guards[0].ops
    assert len(ops) > 50
    assert all(g.ops == ops for g in guards[1:])


def _inputs():
    return torch.arange(12, dtype=torch.float32).reshape(3, 4)


FAULTS = {
    "item": lambda x: x.sum().item(),
    "int": lambda x: int(x[0, 0]),
    "nonzero": lambda x: torch.nonzero(x),
    "masked_select": lambda x: torch.masked_select(x, x > 3),
    "boolean index": lambda x: x[x > 3],
    "unique": lambda x: torch.unique(x),
    "truth value": lambda x: bool((x > 3).any()),
    "host data": lambda x: x + torch.tensor([1.0, 2.0, 3.0, 4.0]),
    "host numpy": lambda x: x * torch.as_tensor(np.ones(4, np.float32)),
    "outside tensor": lambda x: x + OUTSIDE,
}
OUTSIDE = torch.ones(4)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_guard_rejects_what_a_graph_cannot_hold(fault):
    x = _inputs()
    with pytest.raises(StepNotCapturable):
        with StepGuard("cpu", [x]):
            FAULTS[fault](x)


def test_guard_passes_device_ops_and_rejects_a_copy_between_devices():
    x = _inputs()
    with StepGuard("cpu", [x]) as guard:
        y = torch.zeros_like(x)
        y[torch.arange(3), torch.arange(3)] = x[0, :3]
        z = torch.where(x > 3, x, y).sum(dim=0)
        torch.argsort(z, stable=True)
    assert "aten.where.self" in guard.ops
    with pytest.raises(StepNotCapturable, match="meta"):
        with StepGuard("cpu", [x]):
            x.to("meta")
