"""The recurrent blocks of the port against the reference: RWKV6's WKV scan
and Mamba2's SSD scan (chunked and recurrent), the depthwise conv with a
carried state, the group norm, the softplus, the three blocks (rwkv, mamba
and zamba2's shared attention with its per-invocation LoRA merged into the
shared q/k/v weights) in prefill and in one decode step, and the bridged
reduced rwkv6-7b and zamba2-7b end to end, in bf16 and with f32 weights on
both sides.

Inputs come from numpy seeds; the reference runs on the CPU as its own
tests run it (jit; its Pallas sweep in interpret mode). The reference's
init leaves the LoRA B matrices, the norm scales and biases, the conv bias,
dt_bias and gn_scale at zero and D_skip at one, where a wrong merge or a
missing (1 + scale) cannot show: every pair here redraws those leaves from
a numpy seed, the same values on both sides. zamba2 runs two groups (six
layers), so the shared block serves two invocations with distinct LoRA
deltas. Tolerances: fp32 1e-4 of the reference's max |value| (F32_REL);
bf16 2e-2 (REL).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.core import PULConfig as ref_PULConfig
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_T
from repro_torch.configs import get_config
from repro_torch.core.pul import PULConfig
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.bridge import params_from_reference
from repro_torch.serving import PackedKVLayout

REL = 2e-2
F32_REL = 1e-4
B, S, P = 2, 32, 8

#: the pairs, by name: (arch, groups of its pattern, f32 weights)
PAIRS = {"rwkv6-7b": ("rwkv6-7b", 2, False),
         "rwkv6-7b-f32": ("rwkv6-7b", 2, True),
         "zamba2-7b": ("zamba2-7b", 2, False),
         "zamba2-7b-f32": ("zamba2-7b", 2, True)}


def _flat(params):
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _np(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def redraw_constant_leaves(ref_params, seed=11):
    """Every leaf the reference's init leaves constant (all zeros: the LoRA
    B matrices, norm scales, ln/gn scales and biases, conv_b, dt_bias; all
    ones: D_skip) drawn from a numpy seed instead, in its own type: the
    constant plus 0.1 x a standard normal."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        a = np.asarray(leaf.astype(jnp.float32))
        if a.size and (np.all(a == 0) or np.all(a == 1)):
            a = a + 0.1 * rng.standard_normal(a.shape)
            return jnp.asarray(a, jnp.float32).astype(leaf.dtype)
        return leaf
    return jax.tree.map(draw, ref_params)


def make_pair(arch, groups, f32=False, seed=11):
    """(reference config, reference params, port config, port params): the
    reduced config at `groups` groups, the reference's init with its
    constant leaves redrawn, bridged into the port."""
    ref_cfg = ref_get_config(arch).reduced()
    ref_cfg = dataclasses.replace(ref_cfg,
                                  num_layers=groups * len(ref_cfg.pattern))
    ref_params = redraw_constant_leaves(
        ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)), seed)
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              num_layers=ref_cfg.num_layers)
    params = params_from_reference(_flat(ref_params), cfg, device="cpu")
    if f32:
        ref_params = jax.tree.map(lambda a: a.astype(jnp.float32), ref_params)
        params = M.unflatten({k: v.float() for k, v in M.flatten(params)})
    return ref_cfg, ref_params, cfg, params


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(name):
        if name not in made:
            arch, groups, f32 = PAIRS[name]
            ref_cfg, ref_params, cfg, params = make_pair(arch, groups, f32)
            ref_model = ref_build_model(dataclasses.replace(ref_cfg,
                                                            paged_kv=True))
            made[name] = dict(
                ref_cfg=ref_cfg, ref_params=ref_params, cfg=cfg,
                params=params, ref_model=ref_model,
                model=build_model(dataclasses.replace(cfg, paged_kv=True),
                                  params),
                prefill=jax.jit(ref_model.prefill,
                                static_argnames=("max_seq",)),
                decode=jax.jit(ref_model.decode_step),
                rel=F32_REL if f32 else REL)
        return made[name]
    return get


def _close(got, want, what, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = rel * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max|diff| {err} > {bound}"


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


# ----------------------------------------------------------- recurrences
def _wkv_inputs(seed, b=2, s=20, h=2, n=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, n)) * 0.5).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.5).astype(np.float32)
    S0 = rng.standard_normal((b, h, n, n)).astype(np.float32)
    return r, k, v, logw, u, S0


def _ssd_inputs(seed, b=2, s=20, h=3, p=4, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    B_ = rng.standard_normal((b, s, n)).astype(np.float32)
    C_ = rng.standard_normal((b, s, n)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    la = (-np.exp(rng.standard_normal((b, s, h)) * 0.3) * dt).astype(
        np.float32)
    S0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, B_, C_, la, dt, S0


@pytest.mark.parametrize("form", ["chunked", "recurrent"])
def test_wkv_matches_reference(form):
    """RWKV6's WKV scan from a nonzero state, 20 steps in chunks of 8 (the
    last one padded with identity steps): outputs and final state."""
    args = _wkv_inputs(0)
    if form == "chunked":
        want = ref_ssm.rwkv_wkv_chunked(*map(jnp.asarray, args), 8)
        got = SSM.rwkv_wkv_chunked(*map(_t, args), 8)
    else:
        want = ref_ssm.rwkv_wkv_recurrent(*map(jnp.asarray, args))
        got = SSM.rwkv_wkv_recurrent(*map(_t, args))
    for g, w, what in zip(got, want, ("out", "S")):
        _close(g.numpy(), np.asarray(w), f"wkv {form} {what}", F32_REL)


@pytest.mark.parametrize("form", ["chunked", "recurrent"])
def test_ssd_matches_reference(form):
    """Mamba2's SSD scan from a nonzero state, likewise."""
    args = _ssd_inputs(1)
    if form == "chunked":
        want = ref_ssm.mamba_ssd_chunked(*map(jnp.asarray, args), 8)
        got = SSM.mamba_ssd_chunked(*map(_t, args), 8)
    else:
        want = ref_ssm.mamba_ssd_recurrent(*map(jnp.asarray, args))
        got = SSM.mamba_ssd_recurrent(*map(_t, args))
    for g, w, what in zip(got, want, ("out", "h")):
        _close(g.numpy(), np.asarray(w), f"ssd {form} {what}", F32_REL)


@pytest.mark.parametrize("length", [64, 23], ids=["multiple", "ragged"])
@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("scan", ["wkv", "ssd"])
def test_chunked_equals_recurrent(scan, chunk, length):
    """Inside the port, the chunked form equals the step-by-step one (the
    reference's own cases: chunks of 8, 16 and 64, and a length that is not
    a multiple of the chunk, padded with identity steps); the chunk mask's
    -inf survives the exp as exact zeros."""
    if scan == "wkv":
        args = [_t(a) for a in _wkv_inputs(2, s=length)]
        args[-1] = torch.zeros_like(args[-1])
        oc, sc = SSM.rwkv_wkv_chunked(*args, chunk)
        orr, sr = SSM.rwkv_wkv_recurrent(*args)
    else:
        args = [_t(a) for a in _ssd_inputs(3, s=length)]
        oc, sc = SSM.mamba_ssd_chunked(*args, chunk)
        orr, sr = SSM.mamba_ssd_recurrent(*args)
    for a, b, what in ((oc, orr, "out"), (sc, sr, "state")):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=what)


def test_depthwise_conv_with_a_carried_state():
    """The causal depthwise conv in bf16 against the reference's from a
    nonzero state (its K products summed in bf16, tap by tap), and the
    port's own split: the conv over [a; b] equals the conv over a, then
    over b from a's carried state, bitwise."""
    rng = np.random.default_rng(4)
    K, Ch = 4, 24
    xbc = rng.standard_normal((2, 11, Ch)).astype(np.float32)
    w = (rng.standard_normal((K, Ch)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((Ch,)) * 0.1).astype(np.float32)
    st = rng.standard_normal((2, K - 1, Ch)).astype(np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want, want_state = ref_ssm._depthwise_conv(bf(xbc), bf(w), bf(b), bf(st))
    tb = torch.bfloat16
    got, got_state = SSM._depthwise_conv(_t(xbc, tb), _t(w, tb), _t(b, tb),
                                         _t(st, tb))
    _close(got.float().numpy(), _np(want), "conv out", REL)
    np.testing.assert_array_equal(got_state.float().numpy(), _np(want_state))
    x = _t(xbc, tb)
    a_out, a_state = SSM._depthwise_conv(x[:, :6], _t(w, tb), _t(b, tb),
                                         _t(st, tb))
    b_out, b_state = SSM._depthwise_conv(x[:, 6:], _t(w, tb), _t(b, tb),
                                         a_state)
    assert torch.equal(torch.cat([a_out, b_out], 1), got)
    assert torch.equal(b_state, got_state)


def test_group_norm_is_the_population_variance():
    """The time-mix group norm against the reference's formula (jnp.var is
    the population variance); torch's default, the unbiased variance, would
    differ."""
    rng = np.random.default_rng(5)
    out = rng.standard_normal((2, 3, 4, 16)).astype(np.float32) * 3
    scale = rng.standard_normal((4, 16)).astype(np.float32) * 0.1
    bias = rng.standard_normal((4, 16)).astype(np.float32) * 0.1
    o = jnp.asarray(out)
    mean = jnp.mean(o, axis=-1, keepdims=True)
    var = jnp.var(o, axis=-1, keepdims=True)
    want = (o - mean) * jax.lax.rsqrt(var + 64e-5) * (1.0 + scale) + bias
    got = SSM.group_norm(_t(out), _t(scale), _t(bias))
    _close(got.numpy(), np.asarray(want), "group norm", F32_REL)
    t = _t(out)
    unbiased = ((t - t.mean(-1, keepdim=True))
                * torch.rsqrt(t.var(-1, keepdim=True) + 64e-5)
                * (1.0 + _t(scale)) + _t(bias))
    assert not np.allclose(unbiased.numpy(), np.asarray(want), atol=1e-3)


def test_softplus_is_the_references():
    x = np.array([-80, -20, -1, 0, 0.5, 1, 19.5, 20, 20.5, 30, 80],
                 np.float32)
    np.testing.assert_allclose(SSM.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------- blocks
def _block(pair, kind):
    """Layer 1 (group 1) of `kind`'s entry on both sides, the shared block."""
    key = next(k for k in T.group_keys(pair["cfg"]) if k.endswith(kind))
    ref_p = jax.tree.map(lambda a: a[1], pair["ref_params"]["groups"][key])
    p = T._unbind(pair["params"]["groups"][key], pair["cfg"].num_groups)[1]
    return ref_p, p, pair["ref_params"].get("shared"), \
        pair["params"].get("shared")


def _state(pair, kind, seed):
    """A random decode-time cache of one `kind` block (B rows): recurrent
    state, or a token-indexed K/V cache of S rows filled to 12 and 9."""
    cfg = pair["cfg"]
    rng = np.random.default_rng(seed)
    spec = T._block_cache_spec(cfg, kind, B, S)
    want, got = {}, {}
    for k, (shape, dt) in spec.items():
        if k == "idx":
            a = np.asarray([12, 9], np.int32)
            want[k], got[k] = jnp.asarray(a), torch.as_tensor(a)
            continue
        a = rng.standard_normal(shape).astype(np.float32)
        if k in ("k", "v"):
            a[0, 13:], a[1, 10:] = 0, 0
        jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
        want[k] = jnp.asarray(a).astype(jdt)
        got[k] = _t(a, dt)
    return want, got


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("kind", ["rwkv", "mamba", "shared_attn"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_block_matches_reference(pairs, dtype, kind, step):
    """One block on both sides: in prefill over 21 tokens (the output and
    the state or caches it emits), and in one decode step from a given
    state (the output and the next state; for the shared block, the K/V
    rows written at idx). The shared block merges layer 1's LoRA (nonzero
    B matrices)."""
    arch = "rwkv6-7b" if kind == "rwkv" else "zamba2-7b"
    pair = pairs(arch if dtype == "bf16" else f"{arch}-f32")
    ref_cfg, cfg = pair["ref_model"].cfg, pair["model"].cfg
    ref_p, p, ref_shared, shared = _block(pair, kind)
    rng = np.random.default_rng(6)
    T_ = 21 if step == "prefill" else 1
    x = rng.standard_normal((B, T_, cfg.d_model)).astype(np.float32)
    act = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tact = torch.bfloat16 if dtype == "bf16" else torch.float32
    if step == "prefill":
        pos = np.arange(T_)[None]
        want, want_cache, _ = ref_T.block_apply(
            ref_p, ref_shared, jnp.asarray(x).astype(act), cfg=ref_cfg,
            kind=kind, positions=jnp.asarray(pos), step_kind="prefill",
            max_seq=S)
        got, got_cache, _ = T.block_apply(
            p, _t(x, tact), cfg=cfg, kind=kind,
            positions=torch.as_tensor(pos), step_kind="prefill", max_seq=S,
            shared=shared)
    else:
        want_in, got_in = _state(pair, kind, 7)
        if dtype == "f32" and kind == "shared_attn":
            want_in = {k: (v.astype(jnp.float32) if k != "idx" else v)
                       for k, v in want_in.items()}
            got_in = {k: (v.float() if k != "idx" else v)
                      for k, v in got_in.items()}
        pos = np.asarray([[12], [9]])
        want, want_cache, _ = ref_T.block_apply(
            ref_p, ref_shared, jnp.asarray(x).astype(act), cfg=ref_cfg,
            kind=kind, positions=jnp.asarray(pos), step_kind="decode",
            cache=want_in)
        got, got_cache, _ = T.block_apply(
            p, _t(x, tact), cfg=cfg, kind=kind,
            positions=torch.as_tensor(pos), step_kind="decode",
            cache=got_in, shared=shared)
    _close(got.float().numpy(), _np(want), f"{kind} {step} out", pair["rel"])
    assert sorted(got_cache) == sorted(want_cache)
    for k, w in want_cache.items():
        g = got_cache[k]
        if k == "idx":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert g.dtype == {jnp.dtype(jnp.float32): torch.float32,
                               jnp.dtype(jnp.bfloat16): torch.bfloat16}[
                                   w.dtype], k
            _close(g.float().numpy(), _np(w), f"{kind} {step} {k}",
                   pair["rel"])


def test_merged_lora_attn_matches_reference(pairs):
    """zamba2's merge in bf16, one per invocation: wq + (q_a @ q_b) and
    likewise k and v, against the reference's, with nonzero B matrices:
    each merged weight within one bf16 ulp of the reference's; the two
    invocations' merged weights differ; and the factored form
    x @ wq + (x @ q_a) @ q_b, which the port does not use, rounds
    otherwise."""
    pair = pairs("zamba2-7b")
    cfg, ref_cfg = pair["cfg"], pair["ref_model"].cfg
    key = T.group_keys(cfg)[2]
    merged = []
    for g in range(cfg.num_groups):
        ref_lora = jax.tree.map(lambda a: a[g],
                                pair["ref_params"]["groups"][key])
        lora = T._unbind(pair["params"]["groups"][key], cfg.num_groups)[g]
        want = ref_T._merged_lora_attn(pair["ref_params"]["shared"]["attn"],
                                       ref_lora, ref_cfg)
        got = T._merged_lora_attn(pair["params"]["shared"]["attn"], lora, cfg)
        for w in ("wq", "wk", "wv"):
            a, b = got[w].float().numpy(), _np(want[w])
            assert got[w].dtype == torch.bfloat16
            assert np.all(np.abs(a - b) <= 2.0 ** -7 * np.abs(b)), w
            assert not torch.equal(got[w], pair["params"]["shared"]["attn"][w])
        merged.append(got)
    assert not torch.equal(merged[0]["wq"], merged[1]["wq"])
    x = torch.randn((3, cfg.d_model), generator=torch.Generator().manual_seed(
        0)).to(torch.bfloat16)
    lora = T._unbind(pair["params"]["groups"][key], cfg.num_groups)[0]
    wq = pair["params"]["shared"]["attn"]["wq"].reshape(cfg.d_model, -1)
    fused = x @ merged[0]["wq"].reshape(cfg.d_model, -1)
    factored = x @ wq + (x @ lora["q_a"]) @ lora["q_b"]
    assert not torch.equal(fused, factored)


# ---------------------------------------------------------- whole models
def _tokens(cfg, lens, T_, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, T_)).astype(np.int32)
    for b, n in enumerate(lens):
        toks[b, n:] = 0
    return toks


def _to_torch(tree):
    """The reference's cache tree in torch, its types kept."""
    out = {}
    for keys, leaf in _leaves(tree):
        a = torch.from_numpy(_np(leaf).copy())
        if keys[-1] == "idx":
            a = a.to(torch.int32)
        elif leaf.dtype == jnp.bfloat16:
            a = a.to(torch.bfloat16)
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = a
    return out


def _check_cache(got, want, what, rel):
    """Every leaf of a cache tree: idx exact, fp32 leaves within `rel`,
    bf16 leaves (K/V, the conv state, the token-shift carries of a bf16
    model) within REL, one rounding of a value both sides computed."""
    for keys, w in _leaves(want):
        g = _get(got, keys)
        if keys[-1] == "idx":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g.float().numpy(), _np(w), f"{what} {'/'.join(keys)}",
                   REL if w.dtype == jnp.bfloat16 else rel)


def _ref_block(pair, prefix, g):
    return jax.tree.map(lambda a: a[g],
                        pair["ref_params"][prefix[0]][prefix[1]])


def _layerwise(pair, toks, step, caches=None, pos0=None):
    """Every block of one prefill (or decode step from the reference's
    `caches`) run by the reference and by the port on the reference's input
    to that block, in block order, each block's output and cache held
    within the pair's tolerance; then the head on the reference's last
    hidden state. Returns the reference's (logits, caches)."""
    ref_cfg, cfg = pair["ref_model"].cfg, pair["model"].cfg
    batch = {"tokens": jnp.asarray(toks)}
    if pos0 is not None:
        batch["pos0"] = jnp.asarray(pos0)
    x, pos = ref_T._embed_inputs(pair["ref_params"], batch, ref_cfg)
    tpos = torch.as_tensor(np.array(pos), dtype=torch.long)
    act = torch.float32 if x.dtype == jnp.float32 else torch.bfloat16
    new = {}
    for prefix, g, kind, p in T._blocks(pair["params"], cfg):
        rc = None if caches is None else jax.tree.map(
            lambda a: a[g], caches[prefix[0]][prefix[1]])
        want_x, want_c, _ = ref_T.block_apply(
            _ref_block(pair, prefix, g), pair["ref_params"].get("shared"), x,
            cfg=ref_cfg, kind=kind, positions=pos, step_kind=step,
            cache=rc, max_seq=S)
        got_x, got_c, _ = T.block_apply(
            p, torch.from_numpy(_np(x).copy()).to(act), cfg=cfg, kind=kind,
            positions=tpos, step_kind=step,
            cache=None if rc is None else _to_torch(rc), max_seq=S,
            shared=pair["params"].get("shared"))
        what = f"{step} block {prefix[1]} of group {g}"
        _close(got_x.float().numpy(), _np(want_x), f"{what} out", pair["rel"])
        _check_cache(got_c, want_c, what, pair["rel"])
        new.setdefault(prefix[1], []).append(want_c)
        x = want_x
    x = ref_layers.rms_norm(x, pair["ref_params"]["final_norm"], ref_cfg.norm_eps)
    want = ref_layers.logits_apply(pair["ref_params"]["embedding"], x[:, -1:],
                                   cfg=ref_cfg)[:, 0]
    tx = torch.from_numpy(_np(x[:, -1:]).copy()).to(act)
    got = L.logits_apply(pair["params"]["embedding"], tx, cfg=cfg)[:, 0]
    _close(got.numpy(), np.asarray(want), f"{step} head", pair["rel"])
    return want, {"groups": {k: jax.tree.map(lambda *a: jnp.stack(a), *v)
                             for k, v in new.items()}}


@pytest.mark.parametrize("name", list(PAIRS))
def test_model_prefill_and_decode_match_reference(pairs, name):
    """The bridged reduced model: prefill of right-padded rows of 21 and 13
    tokens (bucket 21; logits at each row's last token, and every cache
    leaf: the recurrent state taken past the padding, the shared block's
    K/V and idx), then three teacher-forced dense decode steps.

    With f32 weights, end to end: the port's prefill against the
    reference's (logits and caches), then the port carries its own caches
    from the reference's prefill through the three steps (K/V in f32 on
    both sides): every step's logits and every final cache leaf. In bf16
    the two frameworks' roundings (bf16 products summed in other orders)
    compound past REL end to end (up to 2.6 % of max |logits| in one
    rwkv6 decode step and of zamba2's deepest h after prefill, where the
    reference's own bf16 run sits 1.1-1.7 % from its f32 one), so bf16 is
    held block by block, on the reference's input to each block: every
    block's output and cache in prefill and in each step, and the head."""
    pair = pairs(name)
    cfg = pair["cfg"]
    lens = np.asarray([21, 13], np.int32)
    toks = _tokens(cfg, lens, 21)
    forced = np.random.default_rng(1).integers(1, cfg.vocab_size,
                                               (3, B)).astype(np.int32)
    if pair["rel"] == REL:
        _, caches = _layerwise(pair, toks, "prefill")
        for s, tok in enumerate(forced):
            for blk in caches["groups"].values():
                if "idx" in blk:
                    blk["idx"] = jnp.broadcast_to(jnp.asarray(lens + s),
                                                  blk["idx"].shape)
            _, caches = _layerwise(pair, tok[:, None], "decode", caches,
                                   pos0=lens + s)
        return
    want, caches = pair["prefill"](pair["ref_params"], {
        "tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)},
        max_seq=S)
    got, tcaches = pair["model"].prefill(torch.as_tensor(toks).long(),
                                         torch.as_tensor(lens), max_seq=S)
    _close(got.numpy(), np.asarray(want), "prefill logits", F32_REL)
    assert sorted(k for k, _ in _leaves(caches)) == \
        sorted(k for k, _ in _leaves(tcaches))
    _check_cache(tcaches, caches, "prefill", F32_REL)
    for blk in caches["groups"].values():
        if "idx" in blk:
            blk["idx"] = jnp.broadcast_to(jnp.asarray(lens), blk["idx"].shape)
            blk["k"] = blk["k"].astype(jnp.float32)
            blk["v"] = blk["v"].astype(jnp.float32)
    tcaches = _to_torch(caches)
    for s, tok in enumerate(forced):
        want, caches = pair["decode"](
            pair["ref_params"], {"tokens": jnp.asarray(tok[:, None]),
                                 "pos0": jnp.asarray(lens + s)}, caches)
        got, tcaches = pair["model"].decode_step(
            {"tokens": torch.as_tensor(tok[:, None]).long(),
             "pos0": torch.as_tensor(lens + s).long()}, tcaches)
        _close(got.numpy(), np.asarray(want), f"decode step {s} logits",
               F32_REL)
    _check_cache(tcaches, caches, "after 3 steps", F32_REL)


def _pages(layout, tcaches, lens):
    """Prefill caches packed into planes of P-token pages: slot b's pages at
    frames 2 + b n_pages ... (frames 0 and 1: zero and trash)."""
    n_pages = S // P
    pt = (2 + np.arange(B * n_pages)).reshape(B, n_pages).astype(np.int32)
    packed = layout.pack(tcaches)
    planes = layout.init_planes(2 + B * n_pages, P, torch.bfloat16, "cpu")
    for b, n in enumerate(lens):
        for j in range(-(-n // P)):
            rows = packed[b, j * P:min((j + 1) * P, n)]
            layout.write_frame_packed(
                planes, int(pt[b, j]), F.pad(rows, (0, 0, 0, P - len(rows))))
    return planes, pt


def test_zamba2_shared_attention_through_k1_k2_matches_reference_kernel(
        pairs):
    """zamba2's shared attention block (layer g's LoRA merged) in the paged
    decode step, for both invocations, on one input: through K1 (sweep)
    and K2 (per layer), their plain versions here, against the reference's
    block through its own kernel-true sweep (its Pallas K1 in interpret
    mode) over the same pages of the reference's prefill (rows of 21 and
    13 tokens): the block's output and the committed planes within REL,
    the port's K1 and K2 bitwise equal."""
    pair = pairs("zamba2-7b")
    ref_cfg, cfg = pair["ref_model"].cfg, pair["model"].cfg
    lens = np.asarray([21, 13], np.int32)
    _, caches = pair["prefill"](pair["ref_params"], {
        "tokens": jnp.asarray(_tokens(cfg, lens, 21)),
        "lengths": jnp.asarray(lens)}, max_seq=S)
    layout = PackedKVLayout(cfg, B, S)
    planes0, pt = _pages(layout, _to_torch(caches), lens)
    key = T.group_keys(cfg)[2]
    frames = pt[np.arange(B), lens // P]
    offs = (lens % P).astype(np.int32)
    x = np.random.default_rng(8).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    pos = lens[:, None]
    ref_planes = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                  for k, v in planes0.items()}
    for g in range(cfg.num_groups):
        sweep = ref_layers.PagedSweep(
            jnp.asarray(pt), ref_PULConfig(), jnp.asarray(frames),
            jnp.asarray(offs), dict(ref_planes))
        sweep.prefix, sweep.layer = ("groups", key), g
        want, _, _ = ref_T.block_apply(
            _ref_block(pair, ("groups", key), g),
            pair["ref_params"]["shared"],
            jnp.asarray(x).astype(jnp.bfloat16), cfg=ref_cfg,
            kind="shared_attn", positions=jnp.asarray(pos),
            step_kind="paged_decode",
            cache={"idx": jnp.asarray(lens)}, paged=sweep)
        ref_planes = sweep.planes
        got = {}
        for path in ("sweep", "per-layer"):
            planes = {k: v.clone() for k, v in planes0.items()}
            lora = T._unbind(pair["params"]["groups"][key], cfg.num_groups)[g]
            tx = torch.from_numpy(x).to(torch.bfloat16)
            if path == "sweep":
                paged = L.PagedSweep(torch.as_tensor(pt),
                                     torch.as_tensor(lens), PULConfig(),
                                     torch.as_tensor(frames),
                                     torch.as_tensor(offs), planes)
                paged.prefix, paged.layer = ("groups", key), g
                out, _, _ = T.block_apply(
                    lora, tx, cfg=cfg, kind="shared_attn",
                    positions=torch.as_tensor(pos), step_kind="paged_decode",
                    paged=paged, shared=pair["params"]["shared"])
            else:
                view = layout.page_view_tree(planes)["groups"][key]
                out, new, _ = T.block_apply(
                    lora, tx, cfg=cfg, kind="shared_attn",
                    positions=torch.as_tensor(pos), step_kind="paged_decode",
                    cache={"k": view["k"][g], "v": view["v"][g],
                           "idx": torch.as_tensor(lens)},
                    paged=(torch.as_tensor(pt), PULConfig()),
                    shared=pair["params"]["shared"])
                for leaf in ("k", "v"):
                    plane = planes[f"groups/{key}/{leaf}"]
                    plane[g, torch.as_tensor(frames).long(), :,
                          torch.as_tensor(offs).long(), :] = new[leaf]
            got[path] = (out, planes)
        (o1, p1), (o2, p2) = got["sweep"], got["per-layer"]
        _close(o1.float().numpy(), _np(want), f"invocation {g} out", REL)
        assert torch.equal(o1, o2)
        for k in p1:
            assert torch.equal(p1[k], p2[k]), k
            _close(p1[k][g].float().numpy(), _np(ref_planes[k][g]),
                   f"invocation {g} {k}", REL)


def test_zamba2_paged_decode_paths_agree_bitwise(pairs):
    """The port's whole zamba2 paged decode step, four teacher-forced steps
    from the reference's prefill (pages and Mamba state): the sweep (K1)
    and per-layer (K2) paths give bitwise-equal logits, planes and carried
    state, and the logits stay within REL of the port's dense decode over
    the same caches."""
    pair = pairs("zamba2-7b")
    cfg = pair["cfg"]
    lens = np.asarray([21, 13], np.int32)
    _, caches = pair["prefill"](pair["ref_params"], {
        "tokens": jnp.asarray(_tokens(cfg, lens, 21)),
        "lengths": jnp.asarray(lens)}, max_seq=S)
    tcaches = _to_torch(caches)
    layout = PackedKVLayout(pair["model"].cfg, B, S)
    planes0, pt = _pages(layout, tcaches, lens)
    state0 = {"groups": {k: v for k, v in tcaches["groups"].items()
                         if "idx" not in v}}
    forced = np.random.default_rng(2).integers(1, cfg.vocab_size,
                                               (4, B)).astype(np.int32)
    runs = {}
    for path in ("sweep", "per-layer", "dense"):
        planes = {k: v.clone() for k, v in planes0.items()}
        state = state0
        dense = _to_torch(caches)
        logits = []
        for s, tok in enumerate(forced):
            cur = lens + s
            frames = pt[np.arange(B), cur // P]
            offs = (cur % P).astype(np.int32)
            batch = {"tokens": torch.as_tensor(tok[:, None]).long(),
                     "pos0": torch.as_tensor(cur).long(),
                     "lengths": torch.as_tensor(cur),
                     "page_table": torch.as_tensor(pt),
                     "frames": torch.as_tensor(frames),
                     "offsets": torch.as_tensor(offs)}
            if path == "sweep":
                out, state = pair["model"].paged_decode_step(
                    batch, caches=state, planes=planes)
            elif path == "per-layer":
                tree = layout.page_view_tree(planes)
                tree["groups"].update(state["groups"])
                out, new = pair["model"].paged_decode_step(batch,
                                                           caches=tree)
                layout.commit_token(planes, layout.token_rows(new),
                                    torch.as_tensor(frames).long(),
                                    torch.as_tensor(offs).long())
                state = {"groups": {k: new["groups"][k]
                                    for k in state0["groups"]}}
            else:
                for blk in dense["groups"].values():
                    if "idx" in blk:
                        blk["idx"] = torch.as_tensor(cur)[None].expand(
                            cfg.num_groups, -1).to(torch.int32)
                out, dense = pair["model"].decode_step(
                    {k: batch[k] for k in ("tokens", "pos0")}, dense)
            logits.append(out.numpy())
        runs[path] = (logits, planes, state)
    (l1, p1, s1), (l2, p2, s2) = runs["sweep"], runs["per-layer"]
    for s, (a, b, d) in enumerate(zip(l1, l2, runs["dense"][0])):
        np.testing.assert_array_equal(a, b)
        _close(a, d, f"step {s}: sweep against the dense decode", REL)
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    for keys, leaf in _leaves(s1):
        assert torch.equal(leaf, _get(s2, keys)), keys


def test_bridge_loads_the_recurrent_trees(pairs):
    """The new tree paths (groups/0:rwkv/w0, groups/2:shared_attn/q_a,
    shared/attn/wq, ...) load by name with the port's types, and the
    full-width parameter counts equal the reference's."""
    for name, want in (("rwkv6-7b", ("groups/0:rwkv/w0", "groups/0:rwkv/u",
                                     "groups/0:rwkv/wd_b")),
                       ("zamba2-7b", ("shared/attn/wq", "shared/mlp/w_gate",
                                      "groups/2:shared_attn/q_a",
                                      "groups/0:mamba/A_log",
                                      "groups/1:mamba/conv_w"))):
        flat = dict(M.flatten(pairs(name)["params"]))
        assert set(want) <= set(flat)
        assert flat[want[0]].dtype == (torch.float32 if name == "rwkv6-7b"
                                       else torch.bfloat16)
        arch = PAIRS[name][0]
        ref_flat = jax.eval_shape(
            ref_build_model(ref_get_config(arch)).init, jax.random.PRNGKey(0))
        n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref_flat))
        assert M.count_params(T.model_params(get_config(arch))) == n_ref
