"""Port model (repro_torch.models) vs the reference, reduced qwen3-1.7b and
reduced deepseek-v2-236b (MLA + MoE, an unscanned dense layer 0).

The reference's JAX init (PRNGKey(0)) is flattened by path, exported as
float32 numpy and loaded into the port through ``models.bridge``. Prefill
logits and caches, and teacher-forced paged decode logits, must agree with
the reference within 2e-2 * max|reference|: both compute in bf16 with fp32
softmax/norms, and bf16 rounding of sums the two frameworks order
differently moves values by a few bf16 ulps.
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
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import build_model, init_params
from repro_torch.models import module as M
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.bridge import params_from_reference
from repro_torch.serving.kv_pages import PackedKVLayout

ARCH = "qwen3-1.7b"
DEEPSEEK = "deepseek-v2-236b"
REL = 2e-2
B, BUCKET, S, P = 2, 16, 32, 8
LENGTHS = [16, 11]


def _flat_reference_params(params):
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        flat[key] = np.asarray(leaf.astype(jnp.float32))
    return flat


def _make_pair(arch):
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), paged_kv=True)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    params = params_from_reference(_flat_reference_params(ref_params), cfg,
                                   device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, size=(B, BUCKET)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        tokens[b, n:] = 0
    forced = rng.integers(1, cfg.vocab_size, size=(4, B)).astype(np.int32)
    return dict(ref_model=ref_model, ref_params=ref_params, cfg=cfg,
                model=build_model(cfg, params), tokens=tokens, forced=forced)


@pytest.fixture(scope="module")
def pair():
    return _make_pair(ARCH)


@pytest.fixture(scope="module")
def ds_pair():
    return _make_pair(DEEPSEEK)


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = REL * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max|diff| {err} > {bound}"


def test_bridge_loads_every_reference_leaf_with_the_ports_dtypes(pair):
    params = pair["model"].params
    flat = dict(M.flatten(params))
    spec = dict(M.flatten(T.model_params(pair["cfg"])))
    assert set(flat) == set(spec)
    for path, p in spec.items():
        assert tuple(flat[path].shape) == p.shape and flat[path].dtype == p.dtype
    assert flat["groups/0:global/attn/wq"].dtype == torch.bfloat16
    assert flat["final_norm"].dtype == torch.float32


def test_full_width_parameter_count_matches_reference():
    want = ref_build_model(ref_get_config(ARCH)).num_params()
    got = M.count_params(T.model_params(get_config(ARCH)))
    assert got == want == 1_744_954_368


def test_init_is_seeded_and_follows_reference_std_rules():
    cfg = get_config(ARCH).reduced()
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    wq = lambda p: p["groups"]["0:global"]["attn"]["wq"]
    assert torch.equal(wq(a), wq(b)) and not torch.equal(wq(a), wq(c))
    assert not a["final_norm"].any()                     # zeros init
    # stacked (L, D, H, hd) kernel: fan-in spans every axis but the last
    L_, D, H, hd = wq(a).shape
    std = wq(a).float().std().item()
    assert abs(std - (L_ * D * H) ** -0.5) < 0.1 * (L_ * D * H) ** -0.5
    assert abs(a["embedding"]["table"].float().std().item() - 0.02) < 2e-3


def test_prefill_logits_and_caches_match_reference(pair):
    toks, lens = pair["tokens"], np.asarray(LENGTHS, np.int32)
    want_logits, want_caches = pair["ref_model"].prefill(
        pair["ref_params"], {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, max_seq=S)
    got_logits, got_caches = pair["model"].prefill(
        torch.as_tensor(toks, dtype=torch.long), torch.as_tensor(lens),
        max_seq=S)
    _close(got_logits.numpy(), want_logits, "prefill logits")
    for leaf in ("k", "v"):
        want = np.asarray(want_caches["groups"]["0:global"][leaf]
                          .astype(jnp.float32))
        got = got_caches["groups"]["0:global"][leaf].float().numpy()
        assert got.shape == want.shape
        for b, n in enumerate(LENGTHS):
            _close(got[:, b, :n], want[:, b, :n], f"prefill cache {leaf}")


def _reference_forced_decode(pair):
    ref_model, ref_params = pair["ref_model"], pair["ref_params"]
    lens = np.asarray(LENGTHS, np.int32)
    _, caches = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(pair["tokens"]),
                     "lengths": jnp.asarray(lens)}, max_seq=S)
    # every block's fill level: the per-slot prompt lengths
    for blk in [*caches["groups"].values(), *caches.get("dense", {}).values()]:
        blk["idx"] = jnp.broadcast_to(jnp.asarray(lens), blk["idx"].shape)
    out = []
    for s, tok in enumerate(pair["forced"]):
        logits, caches = ref_model.decode_step(
            ref_params, {"tokens": jnp.asarray(tok[:, None]),
                         "pos0": jnp.asarray(lens + s)}, caches)
        out.append(np.asarray(logits))
    return out


def _port_forced_decode(pair, sweep):
    """Prefill into per-layer planes, then teacher-forced paged decode."""
    cfg, model = pair["cfg"], pair["model"]
    lens = np.asarray(LENGTHS, np.int32)
    _, caches = model.prefill(torch.as_tensor(pair["tokens"], dtype=torch.long),
                              torch.as_tensor(lens), max_seq=BUCKET)
    layout = PackedKVLayout(dataclasses.replace(cfg, paged_kv=True), B, S)
    n_pages = S // P
    planes = layout.init_planes(2 + B * n_pages, P, torch.bfloat16, "cpu")
    pt = (2 + np.arange(B * n_pages)).reshape(B, n_pages).astype(np.int32)
    packed = layout.pack(caches)
    for b, n in enumerate(LENGTHS):
        for j in range(-(-n // P)):
            rows = packed[b, j * P:min((j + 1) * P, n)]
            layout.write_frame_packed(planes, int(pt[b, j]),
                                      F.pad(rows, (0, 0, 0, P - rows.shape[0])))
    out = []
    for s, tok in enumerate(pair["forced"]):
        cur = lens + s
        frames = pt[np.arange(B), cur // P]
        offs = (cur % P).astype(np.int32)
        batch = {"tokens": torch.as_tensor(tok[:, None], dtype=torch.long),
                 "pos0": torch.as_tensor(cur, dtype=torch.long),
                 "lengths": torch.as_tensor(cur),
                 "page_table": torch.as_tensor(pt)}
        if sweep:
            batch["frames"] = torch.as_tensor(frames)
            batch["offsets"] = torch.as_tensor(offs)
            logits, _ = model.paged_decode_step(batch, planes=planes)
        else:
            logits, new = model.paged_decode_step(
                batch, caches=layout.page_view_tree(planes))
            layout.commit_token(planes, layout.token_rows(new),
                                torch.as_tensor(frames).long(),
                                torch.as_tensor(offs).long())
        out.append(logits.numpy())
    return out, planes


def test_teacher_forced_paged_decode_matches_reference(pair):
    want = _reference_forced_decode(pair)
    got_sweep, planes_sweep = _port_forced_decode(pair, sweep=True)
    got_layer, planes_layer = _port_forced_decode(pair, sweep=False)
    for s, (w, g) in enumerate(zip(want, got_sweep)):
        _close(g, w, f"decode step {s} logits")
    # in-port contract: sweep and per-layer paths agree bitwise, and the
    # fused commit left the same planes as the eager one
    for a, b in zip(got_sweep, got_layer):
        np.testing.assert_array_equal(a, b)
    for k in planes_sweep:
        assert torch.equal(planes_sweep[k], planes_layer[k])


def _dense_decode_parity(pair):
    """The port's dense decode (the assembly path's and the dense engine's
    step) against repro's decode_step, four teacher-forced steps from the
    SAME prefilled caches (the reference's, carried over exactly) and
    per-slot pos0. Logits within REL; new caches: idx equal, every row the
    steps did not write bitwise unchanged, the written rows within REL of
    the reference's and bitwise equal in the first layer (its inputs are
    the embeddings alone; deeper rows inherit bf16 rounding differences)."""
    lens = np.asarray(LENGTHS, np.int32)
    _, caches = pair["ref_model"].prefill(
        pair["ref_params"], {"tokens": jnp.asarray(pair["tokens"]),
                             "lengths": jnp.asarray(lens)}, max_seq=S)
    for blk in [*caches["groups"].values(), *caches.get("dense", {}).values()]:
        blk["idx"] = jnp.broadcast_to(jnp.asarray(lens), blk["idx"].shape)
    as_np = lambda x: np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                                 else x)
    before = jax.tree.map(as_np, caches)
    tcaches = jax.tree.map(
        lambda x: torch.from_numpy(as_np(x).copy()).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.int32),
        caches)
    steps = len(pair["forced"])
    for s, tok in enumerate(pair["forced"]):
        want, caches = pair["ref_model"].decode_step(
            pair["ref_params"], {"tokens": jnp.asarray(tok[:, None]),
                                 "pos0": jnp.asarray(lens + s)}, caches)
        got, tcaches = pair["model"].decode_step(
            {"tokens": torch.as_tensor(tok[:, None], dtype=torch.long),
             "pos0": torch.as_tensor(lens + s, dtype=torch.long)}, tcaches)
        _close(got.numpy(), want, f"dense decode step {s} logits")
    first = (["dense", "0"] if pair["cfg"].first_dense_layers
             else ["groups", T.group_keys(pair["cfg"])[0]])
    written = np.zeros((B, S), bool)
    for b, n in enumerate(lens):
        written[b, n:n + steps] = True
    for path, leaf in jax.tree_util.tree_flatten_with_path(caches)[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        node, old = tcaches, before
        for k in keys:
            node, old = node[k], old[k]
        got, want = node.float().numpy(), as_np(leaf)
        assert got.shape == want.shape
        if keys[-1] == "idx":
            np.testing.assert_array_equal(got, want)
            continue
        grouped = keys[0] == "groups"
        g = got if grouped else got[None]           # (L, B, S, feat...)
        w = want if grouped else want[None]
        o = old if grouped else old[None]
        np.testing.assert_array_equal(g[:, ~written], o[:, ~written])
        if keys[:2] == first:
            np.testing.assert_array_equal(g[0][written], w[0][written])
        _close(g[:, written], w[:, written], f"written rows of {keys}")


def test_dense_decode_matches_reference(pair):
    _dense_decode_parity(pair)


def test_unported_archs_and_features_raise():
    """What the reference itself lacks still raises: an unknown arch id, a
    pattern kind outside its block kinds, an attention type other than
    GQA, MLA or none. The recurrent pair builds now: rwkv6-7b (attention
    free) and zamba2-7b (Mamba2 and the shared attention block)."""
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    cfg = get_config(ARCH).reduced()
    for change, what in ((dict(pattern=("conv",)), "pattern kinds"),
                         (dict(pattern=("global", "xattn")), "pattern kinds"),
                         (dict(attn_type="linear"), "attention type")):
        with pytest.raises(NotImplementedError, match=what):
            T.check_supported(dataclasses.replace(cfg, **change))
    for arch, keys in (("rwkv6-7b", {"groups"}),
                       ("zamba2-7b", {"groups", "shared"})):
        rcfg = get_config(arch).reduced()
        T.check_supported(rcfg)
        tree = T.model_params(rcfg)
        assert keys <= set(tree)
    assert get_config("rwkv6-7b").attn_type == "none"
    # frontends and sinusoidal positions are served now
    T.check_supported(dataclasses.replace(
        cfg, frontend="vit_stub", frontend_tokens=4,
        pos_embedding="sinusoidal"))
    # local/global patterns with sandwich norms are served now
    local = dataclasses.replace(cfg, pattern=("local", "global"),
                                sliding_window=16, sandwich_norm=True)
    T.check_supported(local)
    assert "post_norm1" in T.model_params(local)["groups"]["0:local"]


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is legal here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(get_config(ARCH).reduced())


# ---------------------------------------------------------------- deepseek
def test_deepseek_bridge_loads_dense_moe_and_mla_leaves(ds_pair):
    flat = dict(M.flatten(ds_pair["model"].params))
    spec = dict(M.flatten(T.model_params(ds_pair["cfg"])))
    assert set(flat) == set(spec)
    for path, p in spec.items():
        assert tuple(flat[path].shape) == p.shape and flat[path].dtype == p.dtype
    assert flat["groups/0:moe/mlp/router"].dtype == torch.float32
    assert flat["groups/0:moe/mlp/w_gate"].dim() == 4         # (L, E, D, F)
    assert "groups/0:moe/mlp/shared/w_down" in flat
    assert "dense/0/attn/wkv_b" in flat and "dense/0/mlp/w_up" in flat


def test_deepseek_full_width_parameter_count_matches_reference():
    want = ref_build_model(ref_get_config(DEEPSEEK)).num_params()
    assert M.count_params(T.model_params(get_config(DEEPSEEK))) == want


def test_deepseek_prefill_logits_and_caches_match_reference(ds_pair):
    toks, lens = ds_pair["tokens"], np.asarray(LENGTHS, np.int32)
    want_logits, want_caches = ds_pair["ref_model"].prefill(
        ds_pair["ref_params"], {"tokens": jnp.asarray(toks),
                                "lengths": jnp.asarray(lens)}, max_seq=S)
    got_logits, got_caches = ds_pair["model"].prefill(
        torch.as_tensor(toks, dtype=torch.long), torch.as_tensor(lens),
        max_seq=S)
    _close(got_logits.numpy(), want_logits, "prefill logits")
    for keys in (("groups", "0:moe"), ("dense", "0")):
        for leaf in ("c_kv", "k_rope"):
            want = np.asarray(want_caches[keys[0]][keys[1]][leaf]
                              .astype(jnp.float32))
            got = got_caches[keys[0]][keys[1]][leaf].float().numpy()
            assert got.shape == want.shape
            for b, n in enumerate(LENGTHS):
                _close(got[..., b, :n, :], want[..., b, :n, :],
                       f"prefill cache {'/'.join(keys)}/{leaf}")


def test_deepseek_teacher_forced_paged_decode_matches_reference(ds_pair):
    """K3 (sweep) and K4 (per-layer) paths, through their plain versions,
    against the reference's absorbed dense decode; the two paths agree
    bitwise and leave the same planes."""
    want = _reference_forced_decode(ds_pair)
    got_sweep, planes_sweep = _port_forced_decode(ds_pair, sweep=True)
    got_layer, planes_layer = _port_forced_decode(ds_pair, sweep=False)
    for s, (w, g) in enumerate(zip(want, got_sweep)):
        _close(g, w, f"decode step {s} logits")
    for a, b in zip(got_sweep, got_layer):
        np.testing.assert_array_equal(a, b)
    assert sorted(planes_sweep) == ["dense/0/c_kv", "dense/0/k_rope",
                                    "groups/0:moe/c_kv", "groups/0:moe/k_rope"]
    for k in planes_sweep:
        assert torch.equal(planes_sweep[k], planes_layer[k])


def test_deepseek_dense_decode_matches_reference(ds_pair):
    """The absorbed-MLA dense decode (the assembly path's and the dense
    engine's step), through the dense layer 0 and the MoE layers."""
    _dense_decode_parity(ds_pair)


def _moe_layer(ds_pair, cfg_change):
    ref_cfg = dataclasses.replace(ds_pair["ref_model"].cfg, **cfg_change)
    cfg = dataclasses.replace(ds_pair["cfg"], **cfg_change)
    ref_p = jax.tree.map(lambda a: a[0], ds_pair["ref_params"]["groups"]["0:moe"]["mlp"])
    p = T._unbind(ds_pair["model"].params["groups"]["0:moe"]["mlp"],
                  cfg.num_groups)[0]
    return ref_cfg, cfg, ref_p, p


@pytest.mark.parametrize("tokens,capacity_factor", [
    (8, 1.25),      # a decode batch: capacity 8, nothing drops
    (64, 1.25),     # a prefill group
    (64, 0.25),     # capacity 8 for 128 routed slots: tokens drop
], ids=["decode", "prefill", "drops"])
def test_moe_gather_matches_reference(ds_pair, tokens, capacity_factor):
    ref_cfg, cfg, ref_p, p = _moe_layer(
        ds_pair, dict(capacity_factor=capacity_factor))
    rng = np.random.default_rng(tokens)
    x = (rng.standard_normal((2, tokens // 2, cfg.d_model)) * 0.5).astype(
        np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want, want_aux = ref_moe.moe_apply(ref_p, jnp.asarray(x).astype(jnp.bfloat16),
                                       cfg=ref_cfg)
    got, aux = MOE.moe_apply(p, xb, cfg=cfg)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), "moe y")
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)
    # the drop case really drops, and the same slots on both sides
    ids, _, _ = MOE._route(p, xb.reshape(tokens, -1), cfg)
    most = int(torch.bincount(ids.reshape(-1), minlength=cfg.num_experts).max())
    C = MOE._capacity(cfg, tokens)
    assert C == ref_moe._capacity(ref_cfg, tokens)
    assert (most > C) == (capacity_factor < 1)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25],
                         ids=["no-drops", "drops"])
def test_moe_einsum_backend_is_not_ported(ds_pair, capacity_factor):
    """The einsum backend (grok-1's dispatch) on deepseek's reduced expert
    weights and router (softmax -> top-k): a 64-token prefill group against
    the reference's einsum backend, where nothing drops and where tokens
    drop; the model tree builds with it."""
    change = dict(moe_backend="einsum", capacity_factor=capacity_factor)
    ref_cfg, cfg, ref_p, p = _moe_layer(ds_pair, change)
    x = (np.random.default_rng(9).standard_normal((2, 32, cfg.d_model))
         * 0.5).astype(np.float32)
    want, want_aux = ref_moe.moe_apply(
        ref_p, jnp.asarray(x).astype(jnp.bfloat16), cfg=ref_cfg)
    got, aux = MOE.moe_apply(p, torch.from_numpy(x).to(torch.bfloat16),
                             cfg=cfg)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           "einsum moe y")
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)
    T.model_params(cfg)
