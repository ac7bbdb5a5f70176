"""Prompts past 2 * KV_BLOCK = 2048 tokens in the port: the streamed prefill
attention (``models.layers._attend_chunked``) against the reference's, the
reduced qwen3 and deepseek-v2 prefills at T = 2112 against the reference's
with bridged weights, and a ``max_seq`` 4096 engine serving a prompt that
crosses 2048 tokens monolithically and one that crosses it by chunked
prefill.

Tolerances: f32 inputs within 1e-5 (the same arithmetic in another summation
order); bf16 inputs within two bf16 ulps of each output row's largest
|value| (q·kᵀ is a bf16 product in both frameworks, rounded after sums taken
in another order), and 99 % of them bitwise equal (the rounding points are
the reference's); model logits and caches within 2e-2 * max|reference|, as
``test_torch_models`` holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro_torch.configs import get_config
from repro_torch.models import build_model, init_params, layers
from repro_torch.models.bridge import params_from_reference
from repro_torch.serving import PagedEngineConfig, PagedServingEngine, Request

ARCH = "qwen3-1.7b"
DEEPSEEK = "deepseek-v2-236b"
REL = 2e-2
T_LONG = 2112                      # past 2 * KV_BLOCK, real KV_BLOCK
LENGTHS = [T_LONG, 2090]

# (B, T, H, K, hd, vd, kv_block, window, softcap)
CASES = {
    "block-divides": (2, 48, 4, 2, 16, 16, 16, None, None),
    "block-ragged": (2, 40, 4, 2, 16, 16, 16, None, None),
    "window-softcap": (1, 56, 2, 2, 16, 16, 24, 12, 20.0),
    "v-head-dim": (1, 40, 4, 4, 24, 16, 16, None, None),
}


def _bf16_limit(want):
    """Two bf16 ulps of each row's largest |value| (the last axis)."""
    top = np.abs(want).max(axis=-1, keepdims=True)
    return 2.0 * np.exp2(np.floor(np.log2(np.maximum(top, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attend_chunked_matches_reference(case, dtype):
    B, T, H, K, hd, vd, kv_block, window, softcap = CASES[case]
    rng = np.random.default_rng(0)
    q = (rng.standard_normal((B, T, H, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, T, K, hd)) * 0.5).astype(np.float32)
    v = rng.standard_normal((B, T, K, vd)).astype(np.float32)
    kw = dict(softcap=softcap, scale=hd ** -0.5, window=window,
              kv_block=kv_block)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(ref_layers._attend_chunked(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), **kw).astype(jnp.float32))
    got = layers._attend_chunked(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **kw)
    assert got.dtype == tdt and tuple(got.shape) == (B, T, H, vd)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        err = np.abs(got - want) / _bf16_limit(want)
        assert err.max() <= 1.0, f"{err.max()} x two bf16 ulps"
        # the same rounding points give the same bf16 values but for a rare
        # last-bit flip of an fp32 sum taken in another order (at most 0.04 %
        # of them here); p rounded to bf16 before p·v, as `_attend` does,
        # moves about 45 % of them by an ulp, inside the bound above
        assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-236b"])
def test_prefill_reads_its_threshold_at_call_time(arch, monkeypatch):
    """As in the reference: prefill streams when T > 2 * KV_BLOCK as the
    module holds KV_BLOCK at call time (GQA and MLA alike), while the
    streamed attention keeps the kv_block it was defined with (1024: one
    padded block here), and agrees with the dense attention."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, init_params(cfg, seed=0, device="cpu"))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (2, 24)))
    dense, _ = model.prefill(toks)
    streamed = layers._attend_chunked
    calls = []

    def spy(*args, **kw):
        calls.append(kw.get("kv_block", streamed.__kwdefaults__["kv_block"]))
        return streamed(*args, **kw)

    monkeypatch.setattr(layers, "_attend_chunked", spy)
    monkeypatch.setattr(layers, "KV_BLOCK", 8)
    got, _ = model.prefill(toks)
    assert calls == [ref_layers.KV_BLOCK] * cfg.num_layers == \
        [1024] * cfg.num_layers
    _close(got.numpy(), dense.numpy(), "streamed vs dense prefill logits")


# ------------------------------------------------------------ the models
def _flat(params):
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _models(arch):
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), paged_kv=True)
    ref_model = ref_build_model(ref_cfg)
    # one compiled init: the same weights in a third of the eager time
    ref_params = jax.jit(ref_model.init)(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    params = params_from_reference(_flat(ref_params), cfg, device="cpu")
    return ref_cfg, ref_model, ref_params, cfg, params


@pytest.fixture(scope="module")
def qwen3():
    return _models(ARCH)


@pytest.fixture(scope="module")
def deepseek():
    return _models(DEEPSEEK)


def _leaves(tree, prefix=()):
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _leaves(node, (*prefix, key))
        elif key != "idx":
            yield (*prefix, key), node


def _close(got, want, what):
    bound = REL * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max|diff| {err} > {bound}"


@pytest.mark.parametrize("arch", ["qwen3", "deepseek"])
def test_prefill_past_two_kv_blocks_matches_reference(arch, request):
    """Reduced qwen3 (GQA) and deepseek-v2 (MLA, v head dim 16 beside q's
    24) prefill 2112 tokens through the streamed attention."""
    _, ref_model, ref_params, cfg, params = request.getfixturevalue(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(1, cfg.vocab_size, size=(2, T_LONG)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        toks[b, n:] = 0
    lens = np.asarray(LENGTHS, np.int32)
    want_logits, want_caches = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)},
        max_seq=T_LONG)
    got_logits, got_caches = build_model(cfg, params).prefill(
        torch.as_tensor(toks, dtype=torch.long), torch.as_tensor(lens),
        max_seq=T_LONG)
    _close(got_logits.numpy(), np.asarray(want_logits), "prefill logits")
    leaves = dict(_leaves(got_caches))
    assert leaves and len(leaves) == len(dict(_leaves(want_caches)))
    for path, got in leaves.items():
        want = want_caches
        for key in path:
            want = want[key]
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        assert got.shape == want.shape
        seq = 2 if path[0] == "groups" else 1
        for b, n in enumerate(LENGTHS):
            rows = (slice(None), b, slice(0, n)) if seq == 2 else (b, slice(0, n))
            _close(got[rows], want[rows], f"prefill cache {'/'.join(path)}")


# ------------------------------------------------------------ the engine
LONG = dict(batch_slots=2, max_seq=4096, page_tokens=16,
            prefill_buckets=(512, 1024, 2048, 4096), use_paged_kernel=True)
# (prefill_chunk_tokens, prompt lengths): one prompt past 2048 beside a
# short one, prefilled whole at bucket 4096, or by 1024-token chunk passes
# whose last one re-prefills the 2500-token prefix at bucket 4096
SCRIPTS = {"monolithic": (0, (2200, 300)), "chunked": (1024, (2500, 300))}


def _drive(eng, Req, lengths):
    rng = np.random.default_rng(7)
    for rid, n in enumerate(lengths):
        eng.submit(Req(rid=rid, prompt=rng.integers(1, 256, size=n).tolist(),
                       max_new_tokens=4))
    return eng.run()


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_engine_serves_prompts_past_two_kv_blocks(qwen3, script):
    """Every request finishes, and sweep (K1) and per-layer (K2) tokens are
    bitwise equal. (The prefill arithmetic past 2048 tokens is held against
    the reference above; the reference engine at max_seq 4096 would spend
    about 18 s a script on the CPU compiling its 4096 bucket and its
    interpret-mode sweep.)"""
    _, _, _, cfg, params = qwen3
    chunk, lengths = SCRIPTS[script]
    out = {}
    for sweep in (True, False):
        eng = PagedServingEngine(cfg, params, PagedEngineConfig(
            **LONG, prefill_chunk_tokens=chunk, sweep_decode=sweep,
            device="cpu"))
        out[sweep] = _drive(eng, Request, lengths)
        assert eng.metrics.chunk_passes == (3 if chunk else 0)
    assert out[True] == out[False]
    assert sorted(out[True]) == [0, 1]
    assert all(len(t) == 4 for t in out[True].values())
