"""The serving engines at reduced grok-1-314b, internvl2-2b and
musicgen-large against the reference's, and the MoE prefill batch.

Engines: the port's PagedServingEngine on the sweep (K1), per-layer (K2)
and assembly (K5) paths against the reference's paged engine, and its
dense ServingEngine against the reference's, on one script (prompts of 3,
17 and 40 tokens, 6 new each, two slots): tokens equal up to the
reference's first near-tie (2e-2 of max |logits| between the top two,
test_torch_local_attention's rule). For
grok the batch composition is the reference's on every path, prefill
included (below), so its MoE sees the same tokens. Every decode step of the
kernel-true paths passes the capture guard (`StepGuard`).

The MoE prefill batch: capacity dispatch mixes tokens across the batch
(the capacity follows the batch's token count, and the padding rows'
tokens use it up), so an MoE model's prefill builds the reference's
batch, all B slots with the padding rows of token 0. The test admits one
request into slot 1 while slot 0 decodes, at a capacity factor that
drops tokens, with f32 weights on both sides (where the frameworks agree
within F32_REL = 1e-4 of max |logits|, far below the composition's
effect, 0.4-0.7 % on these models), monolithic and chunked.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serving import EngineConfig as RefDenseConfig
from repro.serving import PagedEngineConfig as RefEngineConfig
from repro.serving import PagedServingEngine as RefEngine
from repro.serving import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.models import module as M
from repro_torch.models.bridge import params_from_reference
from repro_torch.serving import (
    EngineConfig,
    PagedEngineConfig,
    PagedServingEngine,
    Request,
    ServingEngine,
)
from repro_torch.serving.capture import StepGuard
from test_torch_local_attention import (
    ENGINE,
    PATHS,
    TIERS,
    _flat,
    _RefDense,
    _RefPaged,
    _upto_first_tie,
)

ARCHS = ("grok-1-314b", "internvl2-2b", "musicgen-large")
F32_REL = 1e-4


def _pair(arch, f32=False, **change):
    """The reference's reduced config and params and the port's, bridged."""
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), **change)
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch).reduced(), **change)
    params = params_from_reference(_flat(ref_params), cfg, device="cpu")
    if f32:
        ref_params = jax.tree.map(lambda a: a.astype(jnp.float32), ref_params)
        params = M.unflatten({k: v.float() for k, v in M.flatten(params)})
    return ref_cfg, ref_params, cfg, params


def _prompts(vocab):
    rng = np.random.default_rng(42)
    return [rng.integers(1, vocab, size=n).tolist() for n in (3, 17, 40)]


@pytest.fixture(scope="module")
def reference_runs():
    """Per arch: the pair, and the tokens and near-ties of the reference's
    paged engine (sweep) and dense engine on the script, with the paged
    engine's decode steps."""
    made = {}

    def get(arch):
        if arch in made:
            return made[arch]
        ref_cfg, ref_params, cfg, params = _pair(arch)
        runs = {}
        for name, eng in (
                ("paged", _RefPaged(ref_cfg, ref_params, RefEngineConfig(
                    **ENGINE, **PATHS["sweep"]))),
                ("dense", _RefDense(ref_cfg, ref_params, RefDenseConfig(
                    batch_slots=2, max_seq=64, prefill_bucket=32)))):
            eng.ties = {}
            for i, p in enumerate(_prompts(ref_cfg.vocab_size)):
                eng.submit(RefRequest(rid=i, prompt=p, max_new_tokens=6))
            runs[name] = (eng.run(), eng.ties,
                          eng.metrics.decode_steps if name == "paged"
                          else None)
        made[arch] = (cfg, params, runs)
        return made[arch]
    return get


@pytest.mark.parametrize("path", [*PATHS, "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_reference(reference_runs, arch, path):
    """The port's paged engine on the sweep (K1), per-layer (K2) and
    assembly (K5, then the dense decode) paths against the reference's
    paged engine, and its dense ServingEngine against the reference's:
    tokens equal up to the first near-tie, the same decode steps."""
    cfg, params, runs = reference_runs(arch)
    if path == "dense":
        eng = ServingEngine(cfg, params, EngineConfig(
            batch_slots=2, max_seq=64, prefill_bucket=32, device="cpu"))
    else:
        eng = PagedServingEngine(cfg, params, PagedEngineConfig(
            **ENGINE, **PATHS[path], device="cpu", **TIERS))
    for i, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    got = eng.run()
    want, ties, steps = runs["dense" if path == "dense" else "paged"]
    assert sorted(got) == sorted(want) == [0, 1, 2]
    assert all(len(v) == 6 for v in got.values())
    _upto_first_tie(got, want, ties)
    if path != "dense":
        assert eng.metrics.decode_steps == steps
        assert eng.metrics.prefills >= 2        # a slot refilled mid-stream


@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "per-layer"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_is_capturable(arch, sweep):
    """Every decode step of a script (a preempt/resume among them) passes
    the capture guard with one op sequence: grok's einsum dispatch reads no
    count or mask back to the host, musicgen's sinusoidal positions are
    made on the device."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    eng = PagedServingEngine(cfg, params, PagedEngineConfig(
        batch_slots=3, max_seq=64, page_tokens=8, prefill_buckets=(8, 16, 32),
        sweep_decode=sweep, device="cpu"))
    guards = []
    step = eng._device_step

    def guarded():
        guard = StepGuard(eng.device, eng.step_inputs())
        guards.append(guard)
        with guard:
            return step()

    eng._device_step = guarded
    rng = np.random.default_rng(3)
    for rid, (n, new) in enumerate(((5, 6), (13, 2), (20, 9), (9, 4))):
        eng.submit(Request(rid=rid, prompt=rng.integers(1, 256, n).tolist(),
                           max_new_tokens=new))
    eng.step()
    eng.preempt(0)
    eng.step()
    eng.resume(0)
    out = eng.run()
    assert all(len(out[r]) == n for r, n in enumerate((6, 2, 9, 4)))
    assert len(guards) == eng.metrics.decode_steps >= 8
    assert all(g.ops == guards[0].ops for g in guards[1:])


# ------------------------------------------------------- MoE prefill batch
def _first_logits(cls):
    class Recorder(cls):
        """Records each request's first emitted logits."""

        def _emit_token(self, slot, logits):
            rid = self.slot_req[slot].rid
            if rid not in self.first:
                self.first[rid] = (slot, np.array(logits, np.float32))
            super()._emit_token(slot, logits)
    return Recorder


@pytest.mark.parametrize("chunk", [0, 8], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b"])
def test_moe_prefill_builds_the_reference_batch(arch, chunk):
    """Request 0 (5 tokens) is admitted into slot 0 and decodes; request 1
    (13 tokens) is then admitted into slot 1 alone, so the reference
    prefills a batch of the padding row (slot 0: token 0, length 1) and
    the prompt (slot 1), at capacity factor 0.5, where tokens drop; with
    `chunk` the prompt takes two chunk passes (8, then 13 tokens), each
    such a batch. Request 1's first-token logits within F32_REL of the
    reference's, and both requests' tokens equal."""
    ref_cfg, ref_params, cfg, params = _pair(arch, f32=True,
                                             capacity_factor=0.5)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (5, 13)]
    kw = dict(**ENGINE, prefill_chunk_tokens=chunk)
    out = {}
    for name, eng, Req in (
            ("reference", _first_logits(RefEngine)(
                ref_cfg, ref_params, RefEngineConfig(**kw)), RefRequest),
            ("port", _first_logits(PagedServingEngine)(
                cfg, params, PagedEngineConfig(**kw, device="cpu", **TIERS)),
             Request)):
        eng.first = {}
        eng.submit(Req(rid=0, prompt=prompts[0], max_new_tokens=6))
        eng.step()
        eng.submit(Req(rid=1, prompt=prompts[1], max_new_tokens=6))
        tokens = eng.run()
        assert eng.slot_req == [None, None]
        assert eng.metrics.chunk_passes == (2 if chunk else 0)
        out[name] = (eng.first[1], tokens)
    ((want_slot, want), want_tokens), ((got_slot, got), got_tokens) = \
        out["reference"], out["port"]
    assert want_slot == got_slot == 1
    err = np.abs(got - want).max()
    assert err <= F32_REL * np.abs(want).max(), \
        f"first-token logits of request 1: max|diff| {err}"
    assert got_tokens == want_tokens
