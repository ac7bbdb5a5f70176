"""Local/global attention in the port vs the reference: reduced qwen2.5-32b
(GQA with qkv bias, one global entry), gemma2-27b (local and global
entries, softcap 50, final softcap 30, sandwich norms, scaled tied
embeddings) and gemma3-12b (five local entries and one global, local rope
theta 1e4, qk_norm). The reduced configs keep a window of 16 tokens;
qwen2.5 and gemma2 run two groups of their pattern deep, gemma3 one group
in bf16 and two with f32 weights (PAIRS).

The reference's JAX init (PRNGKey(0)) is bridged into the port by tree
path; inputs come from numpy seeded 0. Logits and caches must agree within
2e-2 * max|reference| (see test_torch_models): prefill with the local
caches as rings of 16 rows (the prompt's last 16 tokens, token t at row
t % 16) and token-indexed under paged_kv, the dense decode over the ring,
and the paged decode (K1 sweep, K2 per layer, their plain versions here)
at positions past the window. Engine tokens agree with the reference
engines' up to the reference's first near-tie; every decode step of the
paged engine passes the capture guard.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.core import HBM, REMOTE_HBM, TPU_V5E_VPU
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro.serving import EngineConfig as RefDenseConfig
from repro.serving import PagedEngineConfig as RefEngineConfig
from repro.serving import PagedServingEngine as RefEngine
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefDense
from repro_torch.configs import get_config
from repro_torch.core import MemoryTier, PEModel
from repro_torch.models import build_model, init_params
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.models.bridge import params_from_reference
from repro_torch.serving import (
    EngineConfig,
    PackedKVLayout,
    PagedEngineConfig,
    PagedServingEngine,
    Request,
    ServingEngine,
)
from repro_torch.serving.capture import StepGuard

ARCHS = ("qwen2.5-32b", "gemma2-27b", "gemma3-12b")
REL = 2e-2
WINDOW = 16                 # the reduced configs' sliding window
B, S, P = 2, 48, 8


def _flat(params):
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(leaf.astype(jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


#: the pairs the tests hold, by name: (arch, groups of its pattern, f32
#: weights). qwen2.5-32b and gemma2-27b run two groups deep in bf16, so
#: every block of group 1 is layer 1 of its entry's stack. gemma3-12b runs
#: its reduced six layers (one group) in bf16, and two groups with the
#: weights (so the activations) in f32 on both sides: over twelve bf16
#: layers the two frameworks' roundings compound past REL (4.3 % in its
#: deepest caches; in f32 the same caches agree within 0.13 %:
#: tests/torch_depth_drift.py prints the drift layer by layer).
PAIRS = {"qwen2.5-32b": ("qwen2.5-32b", 2, False),
         "gemma2-27b": ("gemma2-27b", 2, False),
         "gemma3-12b": ("gemma3-12b", 1, False),
         "gemma3-12b-f32": ("gemma3-12b", 2, True)}


def _make_pair(name):
    """The reference's reduced model and the port's, at PAIRS[name]'s depth
    and type, with the reference's init bridged."""
    arch, groups, f32 = PAIRS[name]
    ref_cfg = ref_get_config(arch).reduced()
    ref_cfg = dataclasses.replace(ref_cfg,
                                  num_layers=groups * len(ref_cfg.pattern))
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              num_layers=ref_cfg.num_layers)
    params = params_from_reference(_flat(ref_params), cfg, device="cpu")
    if f32:
        ref_params = jax.tree.map(lambda a: a.astype(jnp.float32), ref_params)
        params = M.unflatten({k: v.float() for k, v in M.flatten(params)})
    out = dict(cfg=cfg, params=params, ref_params=ref_params)
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

    def get(arch):
        if arch not in made:
            made[arch] = _make_pair(arch)
        return made[arch]
    return get


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = REL * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max|diff| {err} > {bound}"


def _np(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _tokens(cfg, T_, lengths, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, T_)).astype(np.int32)
    for b, n in enumerate(lengths):
        toks[b, n:] = 0
    return toks


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


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_loads_every_leaf_and_full_width_count_matches(pairs, arch):
    pair = pairs(arch)
    cfg = pair["cfg"]
    flat = dict(M.flatten(pair["params"]))
    spec = dict(M.flatten(T.model_params(cfg)))
    assert set(flat) == set(spec) == set(_flat(pair["ref_params"]))
    assert [k.split("/")[1] for k in spec if k.endswith("/attn/wq")] == \
        T.group_keys(cfg)
    if cfg.sandwich_norm:
        assert all(f"groups/{k}/post_norm2" in flat for k in T.group_keys(cfg))
    want = ref_build_model(ref_get_config(arch)).num_params()
    assert M.count_params(T.model_params(get_config(arch))) == want


def _layerwise_prefill(pair, layout, toks):
    """Each block of the prefill run by the reference and by the port on
    the reference's input to that block, in the port's block order:
    yields (the block's tree keys, layer, the reference's output x and
    cache, the port's)."""
    ref_model, model = pair[layout]
    ref_cfg, cfg = ref_model.cfg, model.cfg
    x, pos = ref_transformer._embed_inputs(
        pair["ref_params"], {"tokens": jnp.asarray(toks)}, ref_cfg)
    tpos = torch.as_tensor(np.array(pos), dtype=torch.long)
    for prefix, g, kind, p in T._blocks(model.params, cfg):
        rp = jax.tree.map(lambda a: a[g],
                          pair["ref_params"][prefix[0]][prefix[1]])
        want_x, want_c, _ = ref_transformer.block_apply(
            rp, None, x, cfg=ref_cfg, kind=kind, positions=pos,
            step_kind="prefill", max_seq=S)
        tx = torch.from_numpy(_np(x).copy()).to(
            torch.float32 if x.dtype == jnp.float32 else torch.bfloat16)
        got_x, got_c = T.block_apply(
            p, tx, cfg=cfg, kind=kind, positions=tpos, step_kind="prefill",
            max_seq=S)
        yield prefix, g, (want_x, want_c), (got_x, got_c)
        x = want_x


@pytest.mark.parametrize("arch,layout", [
    ("qwen2.5-32b", "paged"),           # no local layer: no ring to roll
    ("gemma2-27b", "ring"), ("gemma2-27b", "paged"),
    ("gemma3-12b", "ring"), ("gemma3-12b", "paged"),
    ("gemma3-12b-f32", "ring"), ("gemma3-12b-f32", "paged")])
def test_prefill_logits_and_caches_match_reference(pairs, arch, layout):
    """A 40-token bucket (rows of 40 and 27 real tokens) past the window.
    End to end: the logits, and the cache tree: its paths, shapes and idx
    (a local entry's ring holds the last 16 tokens, rolled to token t at
    row t % 16) and every K/V leaf of every group within REL. Block by
    block, on the reference's input to each block: the block's output and
    every cache row. In the port the ring is the paged prefill's last 16
    rows, rolled, bitwise, and the first block's caches of the whole
    prefill are the block's own, bitwise.

    (gemma3-12b's bf16 caches are held block by block only: its six layers
    compound the two frameworks' bf16 roundings to 3.2 % of the deepest
    caches' largest value end to end. gemma3-12b-f32 holds the whole
    prefill's caches of both groups end to end.)"""
    pair = pairs(arch)
    ref_prefill = pair[f"{layout}_jit"][0]
    model = pair[layout][1]
    lens = np.asarray([40, 27], np.int32)
    toks = _tokens(pair["cfg"], 40, lens)
    want_logits, want = ref_prefill(
        pair["ref_params"], {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, max_seq=S)
    got_logits, got = model.prefill(torch.as_tensor(toks, dtype=torch.long),
                                    torch.as_tensor(lens), max_seq=S)
    _close(got_logits.float().numpy(), want_logits, "prefill logits")
    wtree = jax.tree.map(_np, want)
    assert sorted(k for k, _ in _leaves(got)) == \
        sorted(k for k, _ in _leaves(wtree))
    for keys, leaf in _leaves(got):
        w = _get(wtree, keys)
        assert tuple(leaf.shape) == w.shape, keys
        if keys[-1] == "idx":
            np.testing.assert_array_equal(leaf.numpy(), w)
            continue
        local = keys[1].endswith(":local")
        assert leaf.shape[2] == (WINDOW if local and layout == "ring"
                                 else S), keys
        if arch != "gemma3-12b":
            _close(leaf.float().numpy(), w, "/".join(keys))
    for n, (prefix, g, (want_x, want_c), (got_x, got_c)) in enumerate(
            _layerwise_prefill(pair, layout, toks)):
        what = f"{'/'.join(prefix)}[{g}]"
        _close(got_x.float().numpy(), _np(want_x), f"{what} output")
        for leaf in ("k", "v"):
            _close(got_c[leaf].float().numpy(), _np(want_c[leaf]),
                   f"{what} {leaf}")
            if n == 0:
                assert torch.equal(got_c[leaf],
                                   got[prefix[0]][prefix[1]][leaf][g])
    if layout == "ring" and "local" in pair["cfg"].pattern:
        _, full = pair["paged"][1].prefill(
            torch.as_tensor(toks, dtype=torch.long), torch.as_tensor(lens),
            max_seq=S)
        t = np.arange(40 - WINDOW, 40)
        for key in T.group_keys(pair["cfg"]):
            if key.endswith(":local"):
                for leaf in ("k", "v"):
                    ring = got["groups"][key][leaf]
                    assert torch.equal(ring[:, :, t % WINDOW],
                                       full["groups"][key][leaf][:, :, t])


def _reference_caches(pair, layout, toks, lens):
    """The reference's prefill caches at max_seq S, every idx at the
    per-slot lengths; and the same tree in torch (bf16 K/V, int32 idx)."""
    _, caches = pair[f"{layout}_jit"][0](
        pair["ref_params"], {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, max_seq=S)
    for blk in caches["groups"].values():
        blk["idx"] = jnp.broadcast_to(jnp.asarray(lens), blk["idx"].shape)
    tcaches = jax.tree.map(
        lambda x: torch.from_numpy(_np(x).copy()).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.int32),
        caches)
    return caches, tcaches


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_decode_over_the_ring_matches_reference(pairs, arch):
    """The dense engine's step: the reference's prefilled caches (rings of
    16 rows for local entries) carried over exactly, then 4 teacher-forced
    steps from per-slot fill levels 24 and 19, to position 27, each ring
    overwritten past the window: every step's logits, then every cache
    leaf and idx, within REL."""
    pair = pairs(arch)
    ref_decode = pair["ring_jit"][1]
    model = pair["ring"][1]
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
        _close(got.numpy(), want, f"dense decode step {s} logits")
    for keys, leaf in _leaves(jax.tree.map(_np, caches)):
        got = _get(tcaches, keys).float().numpy()
        if keys[-1] == "idx":
            np.testing.assert_array_equal(got, leaf)
        else:
            _close(got, leaf, "/".join(keys))


def _planes(pair, tcaches, lens):
    """The reference's prefill caches packed into per-layer page planes (one
    plane pair per pattern entry) and the page table: slot b's pages at
    frames 2 + b n_pages ... (frames 0 and 1 are the zero and trash
    frames)."""
    layout = PackedKVLayout(pair["paged"][1].cfg, B, S)
    n_pages = S // P
    planes = layout.init_planes(2 + B * n_pages, P, torch.bfloat16, "cpu")
    pt = (2 + np.arange(B * n_pages)).reshape(B, n_pages).astype(np.int32)
    packed = layout.pack(tcaches)
    for b, n in enumerate(lens):
        for j in range(-(-n // P)):
            rows = packed[b, j * P:min((j + 1) * P, n)]
            layout.write_frame_packed(planes, int(pt[b, j]),
                                      F.pad(rows, (0, 0, 0, P - rows.shape[0])))
    return layout, planes, pt


def _port_forced(pair, tcaches, lens, forced, sweep):
    """Teacher-forced paged decode from the packed planes through K1
    (sweep) or K2 (per layer); returns (logits by step, planes)."""
    model = pair["paged"][1]
    layout, planes, pt = _planes(pair, tcaches, lens)
    out = []
    for s, tok in enumerate(forced):
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


def _reference_forced(pair, tcaches, lens, forced):
    """The same steps through the reference's kernel-true sweep (its Pallas
    K1 in interpret mode) over the same planes; returns (logits by step,
    planes)."""
    ref_model = pair["paged"][0]
    _, planes, pt = _planes(pair, tcaches, lens)
    planes = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
              for k, v in planes.items()}
    step = jax.jit(ref_model.paged_decode_step)
    out = []
    for s, tok in enumerate(forced):
        cur = lens + s
        n = pair["cfg"].num_groups          # placeholders: the planes hold KV
        tree = {"groups": {key: {
            "k": jnp.zeros((n, 1), jnp.bfloat16),
            "v": jnp.zeros((n, 1), jnp.bfloat16),
            "idx": jnp.broadcast_to(jnp.asarray(cur), (n, B))}
            for key in T.group_keys(pair["cfg"])}}
        logits, _, planes = step(
            pair["ref_params"], {
                "tokens": jnp.asarray(tok[:, None]),
                "pos0": jnp.asarray(cur), "page_table": jnp.asarray(pt),
                "frames": jnp.asarray(pt[np.arange(B), cur // P]),
                "offsets": jnp.asarray((cur % P).astype(np.int32))},
            tree, planes)
        out.append(np.asarray(logits))
    return out, {k: _np(v) for k, v in planes.items()}


@pytest.mark.parametrize("arch", [*ARCHS, "gemma3-12b-f32"])
def test_teacher_forced_paged_decode_past_the_window(pairs, arch):
    """Rows of 36 and 25 prompt tokens prefilled by the reference (token-
    indexed caches) and packed into pages, then 5 forced steps to position
    40: every local layer's K1/K2 skips the pages before length - 15.
    Logits within REL of the reference's own kernel-true sweep over the
    same pages; the port's sweep and per-layer paths bitwise equal, and so
    are their planes, which hold the reference's plane set."""
    pair = pairs(arch)
    cfg = pair["cfg"]
    lens = np.asarray([36, 25], np.int32)
    _, tcaches = _reference_caches(pair, "paged", _tokens(cfg, 36, lens),
                                   lens)
    forced = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (5, B)).astype(np.int32)
    want, want_planes = _reference_forced(pair, tcaches, lens, forced)
    got_sweep, planes_sweep = _port_forced(pair, tcaches, lens, forced, True)
    got_layer, planes_layer = _port_forced(pair, tcaches, lens, forced, False)
    assert int(lens.max()) + len(forced) - 1 == 40 > 2 * WINDOW
    for s, (w, g) in enumerate(zip(want, got_sweep)):
        _close(g, w, f"decode step {s} logits")
    for a, b in zip(got_sweep, got_layer):
        np.testing.assert_array_equal(a, b)
    assert sorted(planes_sweep) == sorted(want_planes) == sorted(
        f"groups/{k}/{leaf}" for k in T.group_keys(cfg) for leaf in "kv")
    for k in planes_sweep:
        assert planes_sweep[k].shape == want_planes[k].shape
        assert torch.equal(planes_sweep[k], planes_layer[k])


def test_windowed_streamed_prefill_matches_reference(pairs):
    """A reduced gemma2 prompt of 2112 tokens (past 2 * KV_BLOCK): the
    prefill streams its attention over KV blocks with the window; logits
    and caches (the local ring rolled by 2112 % 16) within REL. The
    streamed attention alone, with softcap 50 and window 16, against the
    reference's and against the port's dense attention with the mask."""
    pair = pairs("gemma2-27b")
    ref_prefill, model = pair["ring_jit"][0], pair["ring"][1]
    n = 2112
    assert n > 2 * L.KV_BLOCK
    lens = np.asarray([n, n - 37], np.int32)
    toks = _tokens(pair["cfg"], n, lens, seed=3)
    want_logits, want = ref_prefill(
        pair["ref_params"], {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, max_seq=n)
    got_logits, got = model.prefill(torch.as_tensor(toks, dtype=torch.long),
                                    torch.as_tensor(lens), max_seq=n)
    _close(got_logits.numpy(), want_logits, "prefill logits")
    for keys, leaf in _leaves(jax.tree.map(_np, want)):
        g = _get(got, keys)
        assert tuple(g.shape) == leaf.shape
        _close(g.float().numpy(), leaf, "/".join(keys))
    assert got["groups"]["0:local"]["k"].shape[2] == WINDOW

    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, n, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    kw = dict(softcap=50.0, scale=0.25, window=WINDOW)
    want = ref_layers._attend_chunked(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), **kw)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = L._attend_chunked(tq, tk, tv, **kw)
    dense = L._attend(tq, tk, tv, softcap=50.0, scale=0.25,
                      mask=L._causal_mask(n, n, window=WINDOW, device="cpu"))
    _close(got.float().numpy(), _np(want), "streamed vs reference")
    _close(got.float().numpy(), dense.float().numpy(), "streamed vs dense")


# ---------------------------------------------------------------- engines
# the reference's page-pool tiers, in the port's types
TIERS = dict(fast_tier=MemoryTier(**dataclasses.asdict(HBM)),
             slow_tier=MemoryTier(**dataclasses.asdict(REMOTE_HBM)),
             pe=PEModel(**dataclasses.asdict(TPU_V5E_VPU)))
ENGINE = dict(batch_slots=2, max_seq=64, page_tokens=8,
              prefill_buckets=(8, 16, 32))
PATHS = {"sweep": dict(use_paged_kernel=True, sweep_decode=True),
         "per-layer": dict(use_paged_kernel=True, sweep_decode=False),
         "assembly": dict(use_paged_kernel=False, use_pallas_gather=True)}


def _prompts(vocab):
    """The reference's gemma2 serving script: prompts of 3, 17 and 40
    tokens (40 > the window of 16), 6 new tokens each."""
    rng = np.random.default_rng(42)
    return [rng.integers(1, vocab, size=n).tolist() for n in (3, 17, 40)]


def _ties(logits):
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return bool(top[1] - top[0] < REL * np.abs(logits).max())


class _RefPaged(RefEngine):
    """Reference paged engine recording whether each token was a near-tie."""

    def _emit_token(self, slot, logits):
        self.ties.setdefault(self.slot_req[slot].rid, []).append(
            _ties(logits))
        super()._emit_token(slot, logits)


class _RefDense(RefDense):
    def _emit(self, logits):
        for i, r in enumerate(self.slot_req):
            if r is not None:
                self.ties.setdefault(r.rid, []).append(_ties(logits[i]))
        super()._emit(logits)


@pytest.fixture(scope="module")
def gemma2_reference_runs(pairs):
    """Tokens and near-ties of the reference's paged engine (sweep) and its
    dense engine on the script, and the paged engine's counters."""
    pair = pairs("gemma2-27b")
    ref_cfg = pair["ring"][0].cfg
    out = {}
    for name, eng in (
            ("paged", _RefPaged(ref_cfg, pair["ref_params"], RefEngineConfig(
                **ENGINE, **PATHS["sweep"]))),
            ("dense", _RefDense(ref_cfg, pair["ref_params"], RefDenseConfig(
                batch_slots=2, max_seq=64, prefill_bucket=32)))):
        eng.ties = {}
        for i, p in enumerate(_prompts(ref_cfg.vocab_size)):
            eng.submit(RefRequest(rid=i, prompt=p, max_new_tokens=6))
        out[name] = (eng.run(), eng.ties,
                     eng.metrics.decode_steps if name == "paged" else None)
    return out


def _upto_first_tie(got, want, ties):
    compared = 0
    for rid, toks in want.items():
        upto = ties[rid].index(True) if True in ties[rid] else len(toks)
        assert got[rid][:upto] == toks[:upto], f"request {rid}"
        compared += upto
    assert compared > 0


@pytest.mark.parametrize("path", [*PATHS, "dense"])
def test_gemma2_engine_tokens_match_reference(pairs, gemma2_reference_runs,
                                              path):
    """The port's paged engine on the sweep (K1), per-layer (K2) and
    assembly (K5, dense decode with the window term) paths against the
    reference's paged engine, and its dense ServingEngine (ring caches)
    against the reference's: tokens equal up to the first near-tie."""
    pair = pairs("gemma2-27b")
    if path == "dense":
        eng = ServingEngine(pair["cfg"], pair["params"], EngineConfig(
            batch_slots=2, max_seq=64, prefill_bucket=32, device="cpu"))
    else:
        eng = PagedServingEngine(pair["cfg"], pair["params"],
                                 PagedEngineConfig(**ENGINE, **PATHS[path],
                                                   device="cpu", **TIERS))
    for i, p in enumerate(_prompts(pair["cfg"].vocab_size)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    got = eng.run()
    want, ties, steps = gemma2_reference_runs[
        "dense" if path == "dense" else "paged"]
    assert sorted(got) == sorted(want) == [0, 1, 2]
    _upto_first_tie(got, want, ties)
    if path != "dense":
        assert eng.metrics.decode_steps == steps
        assert eng.metrics.prefills >= 2        # a slot refilled mid-stream


@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "per-layer"])
@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-12b"])
def test_decode_step_with_windows_is_capturable(arch, sweep):
    """Every decode step of a script past the window (a 20-token prompt
    decoding 9 more, a preempt/resume) passes the capture guard with one
    op sequence, and the paths give the same tokens."""
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
    assert eng.pool.metrics.page_faults >= 1
    assert all(g.ops == guards[0].ops for g in guards[1:])
