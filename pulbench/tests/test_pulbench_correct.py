"""The comparison that decides ``correct``, driven whole at the tiny size
on the CPU (the port's plain kernels under the engine): sound runs pass,
the fp8 control's tokens in place of the served ones come out not correct,
and a timed path broken underneath comes out not correct: a token altered
where it is produced, and a decode step that leaves the KV state unchanged
(its rows never committed)."""
import importlib
import time

import pytest

from pulbench import harness, spec
from pulbench.tests.tiny import tiny_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 21
#: the tiny cells' limit: above the program's widest gap on the CPU
#: (0-0.027 over three seeds a cell, 24-step windows) and below the
#: control's (0.126-0.409)
LIMIT = 0.07


def _run(cell, break_path=None, control=False):
    return harness.run_cell(tiny_cell(cell, LIMIT), SEED, 0.0, False, "cpu",
                            time.perf_counter(), control=control,
                            break_path=break_path)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_correct(cell):
    out = _run(cell)
    assert out.correct, out.checks
    assert out.checks["logit_gap"]["value"] == out.readings["logit_gap"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_not_correct(cell):
    """The control, judged through the run's own checks, fails them; the
    program's gap on the same run stays under the limit."""
    out = _run(cell, control=True)
    assert not out.correct, out.checks
    r = out.readings
    assert out.checks["logit_gap"]["value"] == r["control_logit_gap"]
    assert r["control_logit_gap"] > LIMIT >= r["logit_gap"]
    assert r["control_logit_gap"] > 3 * r["logit_gap"]


def _altered_token(engine):
    """Every fifth token the engine emits is replaced by its successor."""
    emit = engine._emit_token
    count = {"n": 0}

    def altered(slot, logits):
        req = engine.slot_req[slot]
        emit(slot, logits)
        count["n"] += 1
        if count["n"] % 5 == 0:
            req.out_tokens[-1] = ((req.out_tokens[-1] + 1)
                                  % engine.model_cfg.vocab_size)
    engine._emit_token = altered


#: the plain sweep kernels (K1's for GQA, K3's for MLA) and where their
#: planes are among the arguments
SWEEPS = {"paged_sweep_decode_attention_ref": 1,
          "paged_sweep_mla_decode_attention_ref": 2}


def _state_unchanged(engine):
    """Every decode step's K/V rows land in a copy of the planes: the step leaves the cache as it found it."""
    pa = importlib.import_module("repro_torch.kernels.pul_attention")
    for name, at in SWEEPS.items():
        def frozen(*args, _real=getattr(pa, name), _at=at, **kw):
            args = list(args)
            args[_at], args[_at + 1] = args[_at].clone(), args[_at + 1].clone()
            return _real(*args, **kw)
        setattr(pa, name, frozen)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged],
                         ids=["token_altered", "state_unchanged"])
def test_broken_path_not_correct(cell, fault):
    pa = importlib.import_module("repro_torch.kernels.pul_attention")
    saved = {n: getattr(pa, n) for n in SWEEPS}
    try:
        out = _run(cell, break_path=fault)
    finally:
        for n, f in saved.items():
            setattr(pa, n, f)
    assert not out.correct, out.checks
