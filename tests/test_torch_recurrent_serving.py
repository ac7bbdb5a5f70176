"""The serving engines at reduced rwkv6-7b and zamba2-7b (two groups)
against the reference's, and the paged engine's non-pageable state.

Weights: the reference's init with its constant leaves redrawn
(test_torch_ssm.make_pair), bridged. Engines: the port's PagedServingEngine
on the sweep (K1), per-layer (K2) and assembly (K5) paths against the
reference's paged engine on its sweep, and the dense ServingEngine (left
padding fed into the state) against the reference's, on one script
(prompts of 3, 17 and 40 tokens, 6 new each, two slots): tokens equal up to
the reference's first near-tie (2e-2 of max |logits| between the top two),
the same decode steps; the sweep's page-lifecycle trace (shadow_check on)
equal to the reference's event by event. rwkv6 has no pageable KV: every
path decodes by the dense step over ``resident``, as the reference's.

The engine's state: ``resident`` holds the non-pageable leaves only; the
state after a prefill is taken at the bucket's end, past the prompt's
token-0 pads (the reference's quirk, held against its engine); paused and
empty slots advance through the batched step, so preempt/resume and a
policy's swap-out and readmission snapshot and write back the slot's rows
(the streams equal an undisturbed run's); a recurrent model never skips
prefill; a chunked prefill takes its state from the final pass and equals
the monolithic one bitwise; the capture guard passes zamba2's decode step
with the state buffers among its inputs and rejects a state read made
outside the step.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.serving import EngineConfig as RefDenseConfig
from repro.serving import PagedEngineConfig as RefEngineConfig
from repro.serving import PagedServingEngine as RefEngine
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefDense
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving import (
    EngineConfig,
    PagedEngineConfig,
    PagedServingEngine,
    Request,
    ServingEngine,
)
from repro_torch.serving.capture import StepGuard, StepNotCapturable
from test_torch_local_attention import ENGINE, PATHS, TIERS, _ties, \
    _upto_first_tie
from test_torch_sanitizer import _as_dicts
from test_torch_ssm import F32_REL, REL, _get, make_pair

ARCHS = ("rwkv6-7b", "zamba2-7b")


def _prompts(vocab, lens=(3, 17, 40), seed=42):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in lens]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


#: the recurrent state's leaves (the reference's resident tree also holds
#: the pageable K/V and idx)
STATE = ("S", "x_tm", "x_cm", "h", "conv")


def _rows(tree, slot):
    """A slot's rows of every state leaf of a stacked cache tree, as
    float32 numpy, by key path."""
    return {keys: np.asarray(leaf[:, slot].astype(jnp.float32)
                             if not isinstance(leaf, torch.Tensor)
                             else leaf[:, slot].float().numpy().copy())
            for keys, leaf in _leaves(tree) if keys[-1] in STATE}


class _Recording:
    """Records whether each token was a near-tie, and each request's slot
    rows of the resident state right after its prefill."""

    def _emit_token(self, slot, logits):
        rid = self.slot_req[slot].rid
        self.ties.setdefault(rid, []).append(_ties(logits))
        if rid not in self.prefilled:
            self.prefilled[rid] = _rows(self.resident, slot)
        super()._emit_token(slot, logits)


class _RefPaged(_Recording, RefEngine):
    pass


class _Paged(_Recording, PagedServingEngine):
    pass


class _RefDenseTies(RefDense):
    def _emit(self, logits):
        for i, r in enumerate(self.slot_req):
            if r is not None:
                self.ties.setdefault(r.rid, []).append(_ties(logits[i]))
        super()._emit(logits)


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = make_pair(arch, 2)
        return made[arch]
    return get


@pytest.fixture(scope="module")
def reference_runs(pairs):
    """Per arch: the reference's paged engine on its sweep (shadow_check
    on) and its dense engine on the script: (tokens, near-ties, the engine)."""
    made = {}

    def get(arch):
        if arch in made:
            return made[arch]
        ref_cfg, ref_params, _, _ = pairs(arch)
        runs = {}
        for name, eng in (
                ("paged", _RefPaged(ref_cfg, ref_params, RefEngineConfig(
                    **ENGINE, **PATHS["sweep"], shadow_check=True))),
                ("dense", _RefDenseTies(ref_cfg, ref_params, RefDenseConfig(
                    batch_slots=2, max_seq=64, prefill_bucket=32)))):
            eng.ties, eng.prefilled = {}, {}
            for i, p in enumerate(_prompts(ref_cfg.vocab_size)):
                eng.submit(RefRequest(rid=i, prompt=p, max_new_tokens=6))
            runs[name] = (eng.run(), eng.ties, eng)
        made[arch] = runs
        return runs
    return get


def _engine(cfg, params, cls=PagedServingEngine, **kw):
    return cls(cfg, params, PagedEngineConfig(
        **{**ENGINE, **kw}, device="cpu", **TIERS))


@pytest.mark.parametrize("path", [*PATHS, "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_reference(pairs, reference_runs, arch, path):
    """The port's paged engine on each path (shadow_check on) and its dense
    engine against the reference's: tokens equal up to the first
    near-tie, the same decode steps, no lifecycle violation; on the sweep
    the pool's trace equals the reference's event by event."""
    _, _, cfg, params = pairs(arch)
    runs = reference_runs(arch)
    if path == "dense":
        eng = ServingEngine(cfg, params, EngineConfig(
            batch_slots=2, max_seq=64, prefill_bucket=32, device="cpu"))
    else:
        eng = _engine(cfg, params, **PATHS[path], shadow_check=True)
    for i, p in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    got = eng.run()
    want, ties, ref = runs["dense" if path == "dense" else "paged"]
    assert sorted(got) == sorted(want) == [0, 1, 2]
    assert all(len(v) == 6 for v in got.values())
    _upto_first_tie(got, want, ties)
    if path == "dense":
        return
    assert eng.metrics.decode_steps == ref.metrics.decode_steps
    assert eng.metrics.prefills == ref.metrics.prefills >= 2
    assert eng._shadow_checker.violations == []
    if path == "sweep":
        assert _as_dicts(eng.pool.trace.events) == \
            _as_dicts(ref.pool.trace.events)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_state_includes_the_right_padding(arch):
    """The reference's quirk: the paged prefill runs the whole right-padded
    bucket, so a slot's state after prefill is taken at the bucket's end,
    past the prompt's token-0 pads. With f32 weights on both sides, both
    engines admit the script (request 0: 3 tokens in the bucket of 8,
    request 1: 17 in 32) and prefill, without a decode step: each slot's
    rows of ``resident`` within F32_REL of the reference engine's (REL for
    the bf16 conv and token-shift leaves, one rounding), bitwise the
    port's model state after the padded bucket, and not its state after
    the prompt alone."""
    ref_cfg, ref_params, cfg, params = make_pair(arch, 2, f32=True)
    ref = RefEngine(ref_cfg, ref_params, RefEngineConfig(**ENGINE))
    eng = _engine(cfg, params)
    prompts = _prompts(cfg.vocab_size)
    for e, Req in ((ref, RefRequest), (eng, Request)):
        for i, p in enumerate(prompts[:2]):
            e.submit(Req(rid=i, prompt=p, max_new_tokens=6))
        e._admit()
        assert e.metrics.prefills == 2 and e.metrics.decode_steps == 0
    for slot, bucket in ((0, 8), (1, 32)):
        got, want = _rows(eng.resident, slot), _rows(ref.resident, slot)
        assert sorted(got) == sorted(want)
        toks = torch.zeros((1, bucket), dtype=torch.long)
        toks[0, :len(prompts[slot])] = torch.as_tensor(prompts[slot])
        _, padded = eng.model.prefill(toks, max_seq=bucket)
        _, alone = eng.model.prefill(toks[:, :len(prompts[slot])],
                                     max_seq=bucket)
        padded, alone = _rows(padded, 0), _rows(alone, 0)
        for keys, w in want.items():
            rel = F32_REL if keys[-1] in ("S", "h") else REL
            err = np.abs(got[keys] - w).max()
            assert err <= rel * np.abs(w).max(), (slot, keys, err)
            assert np.array_equal(
                got[keys], torch.as_tensor(padded[keys]).to(
                    _get(eng.resident, keys).dtype).float().numpy()), keys
        assert any(not np.array_equal(got[k], alone[k]) for k in got)


def _pause_script(cfg, params, preempt, **kw):
    rng = np.random.default_rng(21)
    pA = rng.integers(1, cfg.vocab_size, size=10).tolist()
    pB = rng.integers(1, cfg.vocab_size, size=7).tolist()
    eng = _engine(cfg, params, **{"prefill_buckets": (16,), **kw})
    eng.submit(Request(rid=0, prompt=pA, max_new_tokens=8))
    eng.submit(Request(rid=1, prompt=pB, max_new_tokens=8))
    for _ in range(3):
        eng.step()
    frozen = None
    if preempt:
        slot = next(i for i, r in enumerate(eng.slot_req) if r and r.rid == 0)
        eng.preempt(slot)
        frozen = _rows(eng.resident, slot)
        for _ in range(2):
            eng.step()       # B decodes while A's state must stay frozen
        moved = _rows(eng.resident, slot)
        assert any(not np.array_equal(frozen[k], moved[k]) for k in frozen)
        eng.resume(slot)
        assert all(np.array_equal(frozen[k], v)
                   for k, v in _rows(eng.resident, slot).items())
    return eng.run()


@pytest.mark.parametrize("arch", ARCHS)
def test_preempt_resume_preserves_recurrent_state(pairs, arch):
    """The port's twin of the reference's test_paged_serving.py
    test_preempt_resume_preserves_recurrent_state_hybrid: a paused slot
    rides through the batched step with token 0 and its rows advance, so
    preempt snapshots them and resume writes them back: the paused
    request's stream equals an undisturbed run's."""
    _, _, cfg, params = pairs(arch)
    assert _pause_script(cfg, params, True)[0] == \
        _pause_script(cfg, params, False)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_archs_never_skip_prefill(pairs, arch):
    """The twin of test_paged_serving.py test_recurrent_archs_never_skip_
    prefill: pages cannot rebuild recurrent state, so an identical,
    page-aligned prompt still prefills."""
    _, _, cfg, params = pairs(arch)
    prompt = list(range(1, 17))
    eng = _engine(cfg, params, prefill_buckets=(16,))
    eng.submit(Request(rid=0, prompt=list(prompt), max_new_tokens=10))
    for _ in range(3):
        eng.step()
    eng.submit(Request(rid=1, prompt=list(prompt), max_new_tokens=4))
    out = eng.run()
    assert eng._has_recurrent
    assert eng.metrics.prefill_skips == 0
    assert eng.metrics.prefills == 2
    assert out[0][:4] == out[1][:4]


@pytest.mark.parametrize("arch", ARCHS)
def test_swap_out_and_readmission_keep_the_state(pairs, arch):
    """Under the priority policy a high-priority arrival preempts the
    lowest-priority running request: its pages spill, its state rows are
    snapshotted and it requeues; readmitted (into whichever slot frees)
    its rows are written back, and its stream equals an undisturbed run's
    bitwise. shadow_check finds no violation."""
    _, _, cfg, params = pairs(arch)
    rng = np.random.default_rng(9)
    pa, pb, pc = (rng.integers(1, cfg.vocab_size, n).tolist()
                  for n in (11, 6, 9))

    def serve(arrival):
        eng = _engine(cfg, params, policy="priority", shadow_check=True,
                      prefill_buckets=(16,))
        eng.submit(Request(rid=0, prompt=pa, max_new_tokens=10, priority=0))
        eng.submit(Request(rid=1, prompt=pb, max_new_tokens=10, priority=1))
        for _ in range(3):
            eng.step()
        if arrival:
            eng.submit(Request(rid=2, prompt=pc, max_new_tokens=3,
                               priority=5))
        out = eng.run()
        assert eng._shadow_checker.violations == []
        return out, eng.metrics
    calm, _ = serve(False)
    busy, m = serve(True)
    assert m.preemptions == 1 and m.readmissions == 1
    assert busy[0] == calm[0] and busy[1] == calm[1]
    assert len(busy[2]) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_equals_monolithic(pairs, arch):
    """A 20-token prompt in chunks of 8 (passes at 8, 16 and 20 tokens,
    the last one at the monolithic bucket of 32): the state is taken from
    the final pass only, so the first token's logits, the slot's state
    rows and the whole stream equal the monolithic prefill's bitwise."""
    _, _, cfg, params = pairs(arch)
    prompt = _prompts(cfg.vocab_size, (20,), seed=3)[0]
    runs = []
    for chunk in (0, 8):
        eng = _engine(cfg, params, _Paged, prefill_chunk_tokens=chunk)
        eng.ties, eng.prefilled = {}, {}
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=6))
        first = {}
        emit = eng._emit_token

        def record(slot, logits, first=first, emit=emit):
            first.setdefault("logits", logits.copy())
            emit(slot, logits)
        eng._emit_token = record
        out = eng.run()
        assert eng.metrics.chunk_passes == (3 if chunk else 0)
        runs.append((out, first["logits"], eng.prefilled[0]))
    (o1, l1, s1), (o2, l2, s2) = runs
    assert o1 == o2
    np.testing.assert_array_equal(l1, l2)
    for k in s1:
        np.testing.assert_array_equal(s1[k], s2[k])


def test_resident_holds_only_the_nonpageable_state(pairs):
    """``resident`` holds the recurrent leaves only (zamba2: each Mamba
    entry's h fp32 and conv bf16, none of the shared attention's K/V or
    idx; rwkv6: S fp32, x_tm and x_cm bf16); an attention-only model has
    none. rwkv6's layout has no feature, and its pool is the reference's
    vestigial one: one packed column, no planes, a page evicted and
    restored through the cold tier."""
    _, _, zcfg, zparams = pairs("zamba2-7b")
    eng = _engine(zcfg, zparams)
    got = {keys: (tuple(v.shape), v.dtype) for keys, v in
           _leaves(eng.resident)}
    B, H, Pd, N = 2, zcfg.ssm_heads, zcfg.d_inner // zcfg.ssm_heads, \
        zcfg.ssm_state
    want = {}
    for key in ("0:mamba", "1:mamba"):
        want[("groups", key, "h")] = ((2, B, H, Pd, N), torch.float32)
        want[("groups", key, "conv")] = (
            (2, B, zcfg.conv_kernel - 1, zcfg.d_inner + 2 * N),
            torch.bfloat16)
    assert got == want and eng._has_recurrent
    assert eng.layout.features == 2 * 2 * zcfg.num_kv_heads * zcfg.head_dim
    _, _, rcfg, rparams = pairs("rwkv6-7b")
    eng = _engine(rcfg, rparams)
    assert {keys[-1]: v.dtype for keys, v in _leaves(eng.resident)} == {
        "S": torch.float32, "x_tm": torch.bfloat16, "x_cm": torch.bfloat16}
    assert eng.layout.features == 0 and eng.pool.planes == {}
    assert eng.pool.features == 1
    assert eng.pool.page_bytes == ENGINE["page_tokens"] * 2
    pid = eng.pool.alloc()
    eng.pool.evict(pid)
    assert eng.pool.ensure_hot([pid]) == 1
    eng.pool.metrics.validate()
    qcfg = get_config("qwen3-1.7b").reduced()
    eng = _engine(qcfg, init_params(qcfg, seed=0, device="cpu"))
    assert eng.resident == {} and not eng._has_recurrent


@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "per-layer"])
def test_capture_guard_passes_the_step_with_its_state(pairs, sweep):
    """Every decode step of zamba2's script (a preempt/resume among them)
    passes the capture guard with one op sequence: the step reads the
    state buffers, among its inputs, and copies each successor into them
    in place; no state leaf is ever rebound. A step that reads a copy of
    the state made outside it is refused."""
    _, _, cfg, params = pairs("zamba2-7b")
    eng = _engine(cfg, params, batch_slots=3, sweep_decode=sweep)
    ptrs = {k: v.data_ptr() for k, v in _leaves(eng.resident)}
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
    assert sum(op.startswith("aten.copy_") for op in guards[0].ops) >= 4
    assert {k: v.data_ptr() for k, v in _leaves(eng.resident)} == ptrs
    # a state leaf swapped for a copy made outside the step
    key = next(iter(eng.resident["groups"]))
    eng.resident["groups"][key]["h"] = eng.resident["groups"][key]["h"] + 0
    inputs = [t for t in eng.step_inputs()
              if t.data_ptr() != eng.resident["groups"][key]["h"].data_ptr()]
    eng.submit(Request(rid=9, prompt=[3] * 5, max_new_tokens=3))
    eng.step()
    with pytest.raises(StepNotCapturable, match="made outside the step"):
        with StepGuard(eng.device, inputs):
            step()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_pool_widths_match_the_reference(arch):
    """At full width rwkv6 has no attention fields (num_heads and
    num_kv_heads 0, so a group of 0): the pool's packed features, page
    bytes and the planner's d* take it as the reference's engine does, and
    zamba2's 27 shared-attention invocations set its page row. Engines of
    2 slots x 64 on 16-token pages, built without weights (neither reads
    them at construction)."""
    kw = dict(batch_slots=2, max_seq=64, page_tokens=16,
              prefill_buckets=(16, 64))
    ref = RefEngine(ref_get_config(arch), {}, RefEngineConfig(**kw))
    eng = PagedServingEngine(get_config(arch), {}, PagedEngineConfig(
        **kw, device="cpu", **TIERS))
    assert eng.layout.features == ref.layout.features
    assert eng.pool.features == ref.pool.features
    assert eng.pool.page_bytes == ref.pool.page_bytes
    assert eng.pool.distance == ref.pool.distance
    assert eng.pool.plan.cfg.distance == ref.pool.plan.cfg.distance
    row = {"rwkv6-7b": 0, "zamba2-7b": 27 * 2 * 32 * 112}[arch]
    assert (eng.layout.features, eng.pool.features) == (row, row or 1)
