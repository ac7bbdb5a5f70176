"""K3/K4's split-KV design (repro_torch.kernels.pul_attention) vs the reference.

The card runs K3/K4 as a split kernel over n_split parts of each row's
visible pages and a merge kernel. :func:`paged_mla_decode_split_ref` is that
arithmetic in plain fp32 PyTorch; here it is held against the reference's
Pallas kernels in interpret mode at every kind of split count (one, a few,
one that does not divide the pages, a page a split) and row (empty, one
token, one page, one page and a token, full), at 4 and 16 heads and rope
widths 8 and 16, within the reference kernel tests' rtol = atol = 3e-4
(tests/test_kernels.py). The split plan is plain Python and is checked
here: it reads the shapes only, aims at one block per SM, pads heads, rope
and page rows to the tensor-core tiles, and fits shared memory.
"""
import functools
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PULConfig as RefPULConfig
from repro.kernels.pul_attention import (
    pul_paged_mla_decode_attention as ref_k4,
    pul_paged_sweep_mla_decode_attention as ref_k3,
)
from repro_torch.core import IssueStrategy, PULConfig

# the module (the package exports the function pul_attention under its name)
PA = importlib.import_module("repro_torch.kernels.pul_attention")

TOL = 3e-4
# (B, H, kvr, dr, P, n_pages, L, lengths): rows of length 0, 1, P, P + 1
# and full (every page)
CASES = {
    "h4-dr8": (5, 4, 32, 8, 8, 6, 2, [0, 1, 8, 9, 48]),
    "h16-dr16": (5, 16, 64, 16, 16, 4, 2, [0, 1, 16, 17, 64]),
}


def _inputs(B, H, kvr, dr, P, n_pages, L, lengths, seed=0):
    rng = np.random.default_rng(seed)
    NF = B * n_pages + 3
    f = lambda *s: (rng.standard_normal(s) * 0.4).astype(np.float32)
    pt = (rng.permutation(NF - 2)[:B * n_pages] + 2).reshape(B, n_pages)
    lens = np.asarray(lengths, np.int32)
    frames = pt[np.arange(B), np.minimum(lens // P, n_pages - 1)]
    # an empty slot and a full one (nowhere to commit: the engine never
    # decodes it) write the TRASH frame, which no stream reads
    frames = np.where((lens == 0) | (lens == n_pages * P), 1,
                      frames).astype(np.int32)
    return dict(qa=f(B, H, kvr), qr=f(B, H, dr), cp=f(L, NF, P, kvr),
                rp=f(L, NF, P, dr), cn=f(B, kvr), rn=f(B, dr),
                pt=pt.astype(np.int32), lens=lens, frames=frames,
                offs=(lens % P).astype(np.int32),
                scale=1.0 / np.sqrt(kvr // 2 + dr))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _reference(case, kernel):
    """The inputs, the plane row read and the reference kernel's out
    (interpret mode), once per case: K3 at the last plane row (with its
    commit), K4 at row 0."""
    B, H, kvr, dr, P, n_pages, L, lengths = CASES[case]
    x = _inputs(*CASES[case])
    j = {k: jnp.asarray(v) for k, v in x.items() if k != "scale"}
    cfg = RefPULConfig(distance=2)
    if kernel == "k3":
        out, _, _ = ref_k3(j["qa"], j["qr"], j["cp"], j["rp"], L - 1, j["pt"],
                           j["lens"], j["cn"], j["rn"], j["frames"],
                           j["offs"], scale=x["scale"], cfg=cfg)
        layer = L - 1
    else:
        out = ref_k4(j["qa"], j["qr"], j["cp"][0], j["rp"][0], j["pt"],
                     j["lens"], j["cn"], j["rn"], scale=x["scale"], cfg=cfg)
        layer = 0
    return x, layer, np.asarray(out)


def _split(x, layer, n_split, with_new=True, drop_split=None):
    new = (_t(x["cn"]), _t(x["rn"])) if with_new else (None, None)
    return PA.paged_mla_decode_split_ref(
        _t(x["qa"]), _t(x["qr"]), _t(x["cp"][layer]), _t(x["rp"][layer]),
        _t(x["pt"]), _t(x["lens"]), *new, scale=x["scale"], n_split=n_split,
        drop_split=drop_split)


@pytest.mark.parametrize("n_split", [1, 2, 3, "pages"])
@pytest.mark.parametrize("kernel", ["k3", "k4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mla_split_model_matches_reference_kernels(case, kernel, n_split):
    x, layer, want = _reference(case, kernel)
    if n_split == "pages":
        n_split = CASES[case][5]           # a page a split
    got = _split(x, layer, n_split)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_split", [1, 2, 3, 6])
def test_mla_split_model_edge_rows(n_split):
    """Length 0 with a current token gives c_new in every head; nothing
    visible and no current token gives 0, as the port's plain version."""
    x, layer, _ = _reference("h4-dr8", "k4")
    H = x["qa"].shape[1]
    got = _split(x, layer, n_split)
    np.testing.assert_allclose(got[0].numpy(), np.repeat(x["cn"][0][None], H, 0),
                               rtol=1e-6, atol=1e-6)
    bare = _split(x, layer, n_split, with_new=False)
    assert not bare[0].any()
    plain = PA.paged_mla_decode_attention_ref(
        _t(x["qa"]), _t(x["qr"]), _t(x["cp"][layer]), _t(x["rp"][layer]),
        _t(x["pt"]), _t(x["lens"]), None, None, scale=x["scale"])
    np.testing.assert_allclose(bare.numpy(), plain.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case,n_split", [("h4-dr8", 2), ("h4-dr8", 3),
                                          ("h16-dr16", 2)])
def test_mla_dropped_split_is_a_fault_the_tolerance_rejects(case, n_split):
    """A merge that leaves one split of the full row out is far outside
    the tolerance: the planted fault of the card checks."""
    x, layer, want = _reference(case, "k3")
    bad = _split(x, layer, n_split, drop_split=n_split - 1)
    assert np.abs(bad.numpy() - want)[-1].max() > 100 * TOL


# ---------------------------------------------------------------- the plan
def _row_bytes(kvr, dr):
    """A shared row: c | r, dr rounded up to 16, and a 16-byte pad."""
    return (kvr + -(-dr // 16) * 16) * 2 + 16


def test_mla_split_plan_reads_the_shapes_only():
    """K3 (planes (L, NF, P, kvr), any layer) and K4 (frames (NP, P, kvr))
    get one plan: the planes' depth and frame count, the layer and the
    lengths are no argument of it."""
    params = set(inspect.signature(PA.mla_split_plan).parameters)
    assert params == {"cfg", "B", "H", "P", "kvr", "dr", "n_pages", "sms",
                      "n_split"}
    plan = PA.mla_split_plan_for(PULConfig(distance=28), 8, 128, 16, 512, 64,
                                 64, 132)
    # deepseek-v2 at the smoke's decode: 8 splits of 8 pages, the engine's
    # d* of 28 clamped to the 7 slots of 18,704 B beside 91,152 B
    assert (plan.n_split, plan.pages_per_split, plan.distance, plan.slots,
            plan.smem_bytes) == (8, 8, 7, 7, 222080)


@pytest.mark.parametrize("B,H,n_pages,sms,want", [
    (8, 128, 64, 132, 8),      # the smoke's decode: 132 // (8 x 2) blocks
    (1, 128, 64, 132, 64),     # one row: every page its own split
    (1, 4, 16, 132, 16),       # capped at the pages
    (64, 128, 64, 132, 1),     # a full grid already
    (8, 128, 64, 78, 4),       # a smaller card
    (4, 16, 64, 132, 33),      # one head block of 64 rows
    (1, 4, 1024, 1000, 256),   # capped at the merge's MLA_MAX_SPLITS
])
def test_mla_split_plan_aims_at_one_block_per_sm(B, H, n_pages, sms, want):
    plan = PA.mla_split_plan(PULConfig(), B=B, H=H, P=16, kvr=512, dr=64,
                             n_pages=n_pages, sms=sms)
    assert plan.n_split == want
    assert plan.pages_per_split == -(-n_pages // want)
    assert plan.distance <= plan.pages_per_split


@pytest.mark.parametrize("dr", [8, 16, 64])
@pytest.mark.parametrize("kvr", [32, 64, 128, 512])
def test_mla_split_plan_fits_shared_memory_and_the_wait_table(kvr, dr):
    for P in (8, 16):
        for distance in (1, 4, 28, 64):
            for strategy in IssueStrategy:
                for n_split in (1, 8, None):
                    plan = PA.mla_split_plan(
                        PULConfig(distance=distance, strategy=strategy), B=8,
                        H=128, P=P, kvr=kvr, dr=dr, n_pages=64,
                        n_split=n_split)
                    seq = strategy is IssueStrategy.SEQUENTIAL
                    row = _row_bytes(kvr, dr)
                    slot = 16 * row + 16
                    aux = PA.MLA_HEADS * row + PA.MLA_XCHG_BYTES + 16
                    assert plan.smem_bytes == plan.slots * slot + aux
                    assert plan.smem_bytes <= PA.SMEM_LIMIT_BYTES
                    assert 1 <= plan.distance <= min(PA.MAX_RING_DISTANCE,
                                                     plan.pages_per_split,
                                                     distance)
                    assert plan.slots >= plan.distance + seq


@pytest.mark.parametrize("small,large", [
    (dict(H=4), dict(H=64)),       # head rows padded to one 64-row block
    (dict(dr=8), dict(dr=16)),     # rope padded to a 16-deep k-step
    (dict(P=8), dict(P=16)),       # page rows padded to a 16-key chunk
])
def test_mla_split_plan_pads_to_the_tensor_core_tiles(small, large):
    base = dict(B=2, H=16, P=16, kvr=64, dr=16, n_pages=8, n_split=2)
    cfg = PULConfig(distance=2)
    assert (PA.mla_split_plan(cfg, **{**base, **small})
            == PA.mla_split_plan(cfg, **{**base, **large}))


def test_mla_split_plan_rejects_a_slab_beyond_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        PA.mla_split_plan(PULConfig(distance=1), B=1, H=128, P=256, kvr=512,
                          dr=64, n_pages=4)
