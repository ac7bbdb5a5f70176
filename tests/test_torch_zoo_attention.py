"""The rest of the attention zoo in the port vs the reference: reduced
grok-1-314b (MoE through the einsum backend, top-k -> softmax routing,
GeGLU experts, softcap 30, scaled tied embeddings), internvl2-2b (GQA with
the vit_stub frontend prefix) and musicgen-large (MHA, sinusoidal
positions, the plain GELU MLP, the cond_stub frontend), two layers each.

The reference's JAX init (PRNGKey(0)) is bridged into the port by tree
path; inputs come from numpy. Tolerances: in bf16, 2e-2 of the reference's
max |value| (REL, as elsewhere in the port); grok also runs with f32
weights on both sides (`grok-1-314b-f32`), where the two frameworks agree
within F32_REL = 1e-4 of max |value| in prefill, and within F32_DECODE_REL
= 1e-3 where the bf16 KV caches feed the decode (an fp32 ulp apart before
the cast, a cache value can round to the next bf16): in bf16 a token whose
two router logits round differently lands in another expert, and grok's
logits then move up to 1.5 % of their largest value. Covered: prefill logits and caches
with and without the frontend prefix (the reference's quirk pinned: with a
prefix, `lengths` index the concatenated sequence), the dense decode, the
teacher-forced paged decode on K1/K2's plain versions against the
reference's own Pallas sweep in interpret mode, the einsum dispatch
(capacity factors that drop and that do not, groups of 2048 tokens),
einsum == gather where nothing drops, grok's routing, the sinusoidal
embedding and the GELU MLP.
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
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.bridge import params_from_reference
from test_torch_local_attention import (
    B,
    S,
    _flat,
    _get,
    _layerwise_prefill,
    _leaves,
    _np,
    _port_forced,
    _reference_caches,
    _reference_forced,
    _tokens,
)

ARCHS = ("grok-1-314b", "internvl2-2b", "musicgen-large")
REL = 2e-2
F32_REL = 1e-4
F32_DECODE_REL = 1e-3

#: the pairs the tests hold, by name: (arch, f32 weights)
PAIRS = {"grok-1-314b": ("grok-1-314b", False),
         "grok-1-314b-f32": ("grok-1-314b", True),
         "internvl2-2b": ("internvl2-2b", False),
         "musicgen-large": ("musicgen-large", False)}


def _make_pair(name):
    """The reference's reduced model and the port's, with the reference's
    init bridged (in the layout of test_torch_local_attention's pairs)."""
    arch, f32 = PAIRS[name]
    ref_cfg = ref_get_config(arch).reduced()
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    params = params_from_reference(_flat(ref_params), cfg, device="cpu")
    if f32:
        ref_params = jax.tree.map(lambda a: a.astype(jnp.float32), ref_params)
        params = M.unflatten({k: v.float() for k, v in M.flatten(params)})
    out = dict(cfg=cfg, params=params, ref_params=ref_params,
               rel=F32_REL if f32 else REL,
               decode_rel=F32_DECODE_REL if f32 else REL)
    for layout, paged in (("ring", False), ("paged", True)):
        ref_model = ref_build_model(dataclasses.replace(ref_cfg,
                                                        paged_kv=paged))
        out[layout] = (ref_model,
                       build_model(dataclasses.replace(cfg, paged_kv=paged),
                                   params))
        out[f"{layout}_jit"] = (
            jax.jit(ref_model.prefill, static_argnames=("max_seq",)),
            jax.jit(ref_model.decode_step))
    return out


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(name):
        if name not in made:
            made[name] = _make_pair(name)
        return made[name]
    return get


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = rel * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max|diff| {err} > {bound}"


def _frontend(cfg, seed=7):
    """A frontend prefix (B, Tf, D): float32 numpy, and the bf16 tensor
    both sides take."""
    fe = (np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_tokens, cfg.d_model)) * 0.5).astype(np.float32)
    return fe, torch.from_numpy(fe).to(torch.bfloat16)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_loads_every_leaf_and_full_width_count_matches(pairs, arch):
    """Every new leaf is loaded by tree path (musicgen's w_in/w_out, grok's
    router and expert tensors under groups/0:moe) and the full-width
    parameter counts equal the reference's."""
    pair = pairs(arch)
    cfg = pair["cfg"]
    flat = dict(M.flatten(pair["params"]))
    assert set(flat) == set(dict(M.flatten(T.model_params(cfg)))) == \
        set(_flat(pair["ref_params"]))
    key = T.group_keys(cfg)[0]
    want = {"grok-1-314b": ("router", "w_gate", "w_up", "w_down"),
            "internvl2-2b": ("w_gate", "w_up", "w_down"),
            "musicgen-large": ("w_in", "w_out")}[arch]
    assert sorted(k.rsplit("/", 1)[1] for k in flat
                  if k.startswith(f"groups/{key}/mlp/")) == sorted(want)
    if arch == "grok-1-314b":
        assert flat["groups/0:moe/mlp/router"].dtype == torch.float32
        assert tuple(flat["groups/0:moe/mlp/w_gate"].shape) == (
            cfg.num_groups, cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    full = ref_build_model(ref_get_config(arch)).num_params()
    assert M.count_params(T.model_params(get_config(arch))) == full


PREFILL_CASES = [("grok-1-314b", False), ("grok-1-314b-f32", False),
                 ("internvl2-2b", False), ("internvl2-2b", True),
                 ("musicgen-large", False), ("musicgen-large", True)]


@pytest.mark.parametrize("name,frontend", PREFILL_CASES,
                         ids=[f"{n}-{'frontend' if f else 'tokens'}"
                              for n, f in PREFILL_CASES])
def test_prefill_logits_and_caches_match_reference(pairs, name, frontend):
    """A 16-token bucket (rows of 16 and 11 real tokens), with or without
    the frontend prefix of Tf = 4 embeddings before the tokens: the logits
    and every cache leaf (Tf + 16 rows of max_seq 48, idx = Tf + 16).

    (bf16 grok's caches past its first layer are held block by block, each
    block on the reference's input to it: a token whose router logits the
    two frameworks round apart takes another expert, which moves the next
    layer's caches past REL end to end. grok-1-314b-f32 holds the whole
    prefill's caches end to end.)"""
    pair = pairs(name)
    cfg, model = pair["cfg"], pair["paged"][1]
    lens = np.asarray([16, 11], np.int32)
    toks = _tokens(cfg, 16, lens)
    batch = {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)}
    fe = tfe = None
    if frontend:
        fe, tfe = _frontend(cfg)
        batch["frontend_embeds"] = jnp.asarray(fe).astype(jnp.bfloat16)
    want_logits, want = pair["paged_jit"][0](pair["ref_params"], batch,
                                             max_seq=S)
    got_logits, got = model.prefill(torch.as_tensor(toks, dtype=torch.long),
                                    torch.as_tensor(lens), max_seq=S,
                                    frontend_embeds=tfe)
    _close(got_logits.numpy(), want_logits, "prefill logits", pair["rel"])
    wtree = jax.tree.map(_np, want)
    assert sorted(k for k, _ in _leaves(got)) == \
        sorted(k for k, _ in _leaves(wtree))
    for keys, leaf in _leaves(got):
        w = _get(wtree, keys)
        assert tuple(leaf.shape) == w.shape, keys
        if keys[-1] == "idx":
            np.testing.assert_array_equal(leaf.numpy(), w)
            assert (w == 16 + (cfg.frontend_tokens if frontend else 0)).all()
        elif name != "grok-1-314b":
            _close(leaf.float().numpy(), w, "/".join(keys), pair["rel"])
        else:
            _close(leaf[0].float().numpy(), w[0], "/".join(keys))
    if name == "grok-1-314b":
        for prefix, g, (want_x, want_c), (got_x, got_c) in \
                _layerwise_prefill(pair, "paged", toks):
            what = f"{'/'.join(prefix)}[{g}]"
            _close(got_x.float().numpy(), _np(want_x), f"{what} output")
            for leaf in ("k", "v"):
                _close(got_c[leaf].float().numpy(), _np(want_c[leaf]),
                       f"{what} {leaf}")


@pytest.mark.parametrize("arch", ["internvl2-2b", "musicgen-large"])
def test_frontend_lengths_index_the_concatenated_sequence(pairs, arch):
    """The reference's quirk, kept: with a frontend prefix of Tf rows and
    `lengths`, the logits are read at lengths - 1 of the concatenated
    sequence (Tf + T rows), not at Tf + lengths - 1. A row of length n
    gives the logits of the last position of a prefill of the prefix and
    the row's first n - Tf tokens, not those of its first n tokens; the
    reference's are within REL."""
    pair = pairs(arch)
    cfg, model = pair["cfg"], pair["paged"][1]
    Tf = cfg.frontend_tokens
    lens = np.asarray([10, 7], np.int32)
    toks = _tokens(cfg, 16, lens, seed=4)
    fe, tfe = _frontend(cfg, seed=5)
    want, _ = pair["paged_jit"][0](
        pair["ref_params"], {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens),
                             "frontend_embeds":
                                 jnp.asarray(fe).astype(jnp.bfloat16)},
        max_seq=S)
    got, _ = model.prefill(torch.as_tensor(toks, dtype=torch.long),
                           torch.as_tensor(lens), max_seq=S,
                           frontend_embeds=tfe)
    _close(got.numpy(), want, "quirk logits", pair["rel"])
    tt = torch.as_tensor(toks, dtype=torch.long)
    for b, n in enumerate(lens):
        at, _ = model.prefill(tt[b:b + 1, :n - Tf], max_seq=S,
                              frontend_embeds=tfe[b:b + 1])
        _close(got[b].numpy(), at[0].numpy(), f"row {b} at lengths - 1")
        shifted, _ = model.prefill(tt[b:b + 1, :n], max_seq=S,
                                   frontend_embeds=tfe[b:b + 1])
        assert not torch.allclose(got[b], shifted[0], atol=1e-3), \
            f"row {b}: logits read at Tf + lengths - 1"


@pytest.mark.parametrize("name", ARCHS)
def test_dense_decode_matches_reference(pairs, name):
    """The dense engine's step: the reference's prefilled caches (lengths
    24 and 19) carried over exactly, then 4 teacher-forced steps (sinusoidal
    positions from pos0 for musicgen, the einsum MoE over the batch of 2 for
    grok): every step's logits, then every cache leaf and idx."""
    pair = pairs(name)
    ref_decode, model = pair["ring_jit"][1], pair["ring"][1]
    cfg = pair["cfg"]
    lens = np.asarray([24, 19], np.int32)
    caches, tcaches = _reference_caches(pair, "ring", _tokens(cfg, 24, lens),
                                        lens)
    forced = np.random.default_rng(1).integers(1, cfg.vocab_size, (4, B))
    for s, tok in enumerate(forced.astype(np.int32)):
        want, caches = ref_decode(
            pair["ref_params"], {"tokens": jnp.asarray(tok[:, None]),
                                 "pos0": jnp.asarray(lens + s)}, caches)
        got, tcaches = model.decode_step(
            {"tokens": torch.as_tensor(tok[:, None], dtype=torch.long),
             "pos0": torch.as_tensor(lens + s, dtype=torch.long)}, tcaches)
        _close(got.numpy(), want, f"dense decode step {s} logits",
               pair["decode_rel"])
    for keys, leaf in _leaves(jax.tree.map(_np, caches)):
        got = _get(tcaches, keys).float().numpy()
        if keys[-1] == "idx":
            np.testing.assert_array_equal(got, leaf)
        else:
            _close(got, leaf, "/".join(keys), pair["decode_rel"])


@pytest.mark.parametrize("name", list(PAIRS))
def test_teacher_forced_paged_decode_matches_reference_kernel(pairs, name):
    """Rows of 36 and 25 prompt tokens prefilled by the reference and packed
    into pages, then 5 forced steps through K1 (sweep) and K2 (per layer),
    their plain versions here, at grok's G = 2 with softcap 30,
    internvl2's G = 2 and musicgen's G = 1: logits within tolerance of the
    reference's own kernel-true sweep (its Pallas K1 in interpret mode)
    over the same pages, and the planes (bf16 on both sides, so within
    REL); the port's two paths and their planes bitwise equal."""
    pair = pairs(name)
    cfg = pair["cfg"]
    lens = np.asarray([36, 25], np.int32)
    _, tcaches = _reference_caches(pair, "paged", _tokens(cfg, 36, lens),
                                   lens)
    forced = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (5, B)).astype(np.int32)
    want, want_planes = _reference_forced(pair, tcaches, lens, forced)
    got_sweep, planes_sweep = _port_forced(pair, tcaches, lens, forced, True)
    got_layer, planes_layer = _port_forced(pair, tcaches, lens, forced, False)
    for s, (w, g) in enumerate(zip(want, got_sweep)):
        _close(g, w, f"decode step {s} logits", pair["decode_rel"])
    for a, b in zip(got_sweep, got_layer):
        np.testing.assert_array_equal(a, b)
    assert sorted(planes_sweep) == sorted(want_planes)
    for k in planes_sweep:
        assert planes_sweep[k].shape == want_planes[k].shape
        assert torch.equal(planes_sweep[k], planes_layer[k])
        _close(planes_sweep[k].float().numpy(), want_planes[k], k)


# ------------------------------------------------------------------- MoE
def _grok_layer(pairs, **change):
    pair = pairs("grok-1-314b")
    ref_cfg = dataclasses.replace(pair["paged"][0].cfg, **change)
    cfg = dataclasses.replace(pair["cfg"], **change)
    ref_p = jax.tree.map(lambda a: a[0],
                         pair["ref_params"]["groups"]["0:moe"]["mlp"])
    p = T._layer(pair["params"]["groups"]["0:moe"]["mlp"], 0)
    return ref_cfg, cfg, ref_p, p


def _activations(tokens, d_model, seed):
    x = (np.random.default_rng(seed).standard_normal((1, tokens, d_model))
         * 0.5).astype(np.float32)
    return x, jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("tokens,capacity_factor", [
    (2, 1.25),          # a decode batch: one group, capacity 8
    (64, 1.25),         # a prefill group
    (64, 0.25),         # capacity 8 for 128 routed slots: tokens drop
    (2100, 1.25),       # two groups of 2048, the second zero-padded
], ids=["decode", "prefill", "drops", "two-groups"])
def test_moe_einsum_matches_reference(pairs, tokens, capacity_factor):
    """grok's einsum dispatch on its reduced layer 0 against the
    reference's: y within REL, the auxiliary loss within 1e-5; the drop
    case drops (some expert's slots exceed C), the others do not."""
    ref_cfg, cfg, ref_p, p = _grok_layer(pairs,
                                         capacity_factor=capacity_factor)
    _, jx, tx = _activations(tokens, cfg.d_model, tokens)
    want, want_aux = ref_moe.moe_apply(ref_p, jx, cfg=ref_cfg)
    got, aux = MOE.moe_apply(p, tx, cfg=cfg)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), "moe y")
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)
    Tg = min(tokens, 2048)
    C = MOE._capacity(cfg, Tg)
    ids, _, _ = MOE._route(p, tx.reshape(tokens, -1)[:Tg], cfg)
    most = int(torch.bincount(ids.reshape(-1),
                              minlength=cfg.num_experts).max())
    assert (most > C) == (capacity_factor < 1)


def test_moe_einsum_equals_gather_where_nothing_drops(pairs):
    """Both dispatch backends agree when the capacity drops nothing
    (capacity factor 8; the reference's own check, atol 2e-2), and the
    port's einsum agrees with the reference's einsum there."""
    ref_cfg, cfg, ref_p, p = _grok_layer(pairs, capacity_factor=8.0)
    _, jx, tx = _activations(32, cfg.d_model, 1)
    tx = tx.reshape(2, 16, -1)
    y1, _ = MOE.moe_apply(p, tx, cfg=cfg)
    y2, _ = MOE.moe_apply(p, tx, cfg=dataclasses.replace(
        cfg, moe_backend="gather"))
    np.testing.assert_allclose(y1.float().numpy(), y2.float().numpy(),
                               atol=2e-2)
    want, _ = ref_moe.moe_apply(ref_p, jx.reshape(2, 16, -1), cfg=ref_cfg)
    _close(y1.float().numpy(), np.asarray(want.astype(jnp.float32)),
           "einsum y")


def test_grok_routing_matches_reference(pairs):
    """Top-k over the router logits, then a softmax over the k: the same
    experts in the same order as the reference's (ties to the lower id),
    weights within 1e-6 that sum to 1; deepseek's order (softmax, then
    top-k) would take the same experts with unnormalised weights."""
    ref_cfg, cfg, ref_p, p = _grok_layer(pairs)
    _, jx, tx = _activations(64, cfg.d_model, 3)
    want_ids, want_w, want_aux = ref_moe._route(ref_p, jx[0], ref_cfg)
    ids, w, aux = MOE._route(p, tx[0], cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=1e-6)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)
    other = dataclasses.replace(cfg, name="not-grok")
    ids2, w2, _ = MOE._route(p, tx[0], other)
    np.testing.assert_array_equal(ids2.numpy(), ids.numpy())
    assert (w2.sum(-1) < 1.0 - 1e-3).all()


# ------------------------------------------------------------ the layers
def test_sinusoidal_embedding_and_gelu_mlp_match_reference(pairs):
    """musicgen's position embedding, [sin | cos] in fp32 at positions up
    to 4095, within 1e-3 of the reference's and of numpy's (one fp32 ulp
    of a frequency moves an angle near 4096 by 2.4e-4), and its plain GELU
    MLP (tanh approximation, bf16) on its reduced layer 0 within REL."""
    pos = np.arange(4096, dtype=np.int32).reshape(2, 2048)
    want = np.asarray(ref_layers.sinusoidal_embedding(jnp.asarray(pos), 64))
    got = L.sinusoidal_embedding(torch.as_tensor(pos), 64)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2048, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    np.testing.assert_allclose(got[..., :32].numpy(),
                               np.sin(pos[..., None] * 1e4 ** (
                                   -np.arange(32) / 32)), atol=1e-3)
    pair = pairs("musicgen-large")
    cfg = pair["cfg"]
    ref_p = jax.tree.map(lambda a: a[0],
                         pair["ref_params"]["groups"]["0:global"]["mlp"])
    p = T._layer(pair["params"]["groups"]["0:global"]["mlp"], 0)
    _, jx, tx = _activations(16, cfg.d_model, 8)
    want = ref_layers.mlp_apply(ref_p, jx, cfg=pair["paged"][0].cfg)
    got = L.mlp_apply(p, tx, cfg=cfg)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           "gelu mlp")
