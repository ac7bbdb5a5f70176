"""K1/K2's split-KV design (repro_torch.kernels.pul_attention) vs the reference.

The card runs K1/K2 as a split kernel over n_split parts of each row's
visible pages and a merge kernel. :func:`paged_decode_split_ref` is that
arithmetic in plain fp32 PyTorch; here it is held against the reference's
Pallas kernels in interpret mode at every kind of split count (one, a few,
more than the pages) and row (empty, one page, one page and a token, long),
with and without the current token, within the reference kernel tests'
rtol = atol = 3e-4 (tests/test_kernels.py). The split plan and K5's bulk
plan are plain Python and are checked here: they fit shared memory at
every head dim and group, and the split plan reads the shapes only.
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
    pul_paged_decode_attention as ref_k2,
    pul_paged_sweep_decode_attention as ref_k1,
)
from repro_torch.core import IssueStrategy, PULConfig
from repro_torch.kernels.pul_gather import gather_bulk_plan

# the module (the package exports the function pul_attention under its name)
PA = importlib.import_module("repro_torch.kernels.pul_attention")

TOL = 3e-4
# (B, H, K, hd, P, n_pages, L, lengths, window, softcap): rows of length 0,
# P, P + 1 and a long one (6 of 6 pages)
CASES = {
    "mixed": (4, 4, 2, 16, 8, 6, 2, [0, 8, 9, 45], None, None),
    "window+softcap": (4, 4, 2, 16, 8, 6, 2, [0, 8, 9, 45], 11, 8.0),
    # without a current token a row with nothing visible has no reference
    # value to hold (the reference averages masked rows, the port gives 0)
    "no-empty-row": (4, 4, 2, 16, 8, 6, 2, [8, 9, 45, 3], None, None),
}
# one split, a few, a count that does not divide the pages, more than pages
SPLITS = [1, 2, 3, 9]


def _inputs(B, H, K, hd, P, n_pages, L, lengths, seed=0):
    rng = np.random.default_rng(seed)
    NF = B * n_pages + 3
    f = lambda *s, a=1.0: (rng.standard_normal(s) * a).astype(np.float32)
    pt = (rng.permutation(NF - 2)[:B * n_pages] + 2).reshape(B, n_pages)
    lens = np.asarray(lengths, np.int32)
    frames = pt[np.arange(B), np.minimum(lens // P, n_pages - 1)]
    frames = np.where((lens == 0) | (lens == n_pages * P), 1,
                      frames).astype(np.int32)
    return dict(q=f(B, H, hd, a=0.4), kp=f(L, NF, K, P, hd, a=0.4),
                vp=f(L, NF, K, P, hd), kn=f(B, K, hd, a=0.4), vn=f(B, K, hd),
                pt=pt.astype(np.int32), lens=lens, frames=frames,
                offs=(lens % P).astype(np.int32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _reference(case, kernel, with_new):
    """The inputs and the reference kernel's out (interpret mode), once per
    case: K1 at the last plane row, K2 at row 0."""
    B, H, K, hd, P, n_pages, L, lengths, window, softcap = CASES[case]
    x = _inputs(B, H, K, hd, P, n_pages, L, lengths)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    kw = dict(cfg=RefPULConfig(distance=2), softcap=softcap, window=window)
    if kernel == "k1":
        out, _, _ = ref_k1(j["q"], j["kp"], j["vp"], L - 1, j["pt"],
                           j["lens"], j["kn"], j["vn"], j["frames"],
                           j["offs"], **kw)
        layer = L - 1
    else:
        new = dict(k_new=j["kn"], v_new=j["vn"]) if with_new else {}
        out = ref_k2(j["q"], j["kp"][0], j["vp"][0], j["pt"], j["lens"],
                     **kw, **new)
        layer = 0
    return x, layer, np.asarray(out)


def _split(x, layer, case, n_split, with_new=True, drop_split=None):
    *_, window, softcap = CASES[case]
    new = dict(k_new=_t(x["kn"]), v_new=_t(x["vn"])) if with_new else {}
    return PA.paged_decode_split_ref(
        _t(x["q"]), _t(x["kp"][layer]), _t(x["vp"][layer]), _t(x["pt"]),
        _t(x["lens"]), n_split=n_split, softcap=softcap, window=window,
        drop_split=drop_split, **new)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("case", ["mixed", "window+softcap"])
def test_split_model_matches_reference_sweep_kernel(case, n_split):
    x, layer, want = _reference(case, "k1", True)
    got = _split(x, layer, case, n_split)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("case,with_new", [("mixed", True),
                                           ("no-empty-row", False)])
def test_split_model_matches_reference_per_layer_kernel(case, with_new,
                                                        n_split):
    x, layer, want = _reference(case, "k2", with_new)
    got = _split(x, layer, case, n_split, with_new=with_new)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_split", SPLITS)
def test_split_model_edge_rows(n_split):
    """Length 0 with a current token gives v_new; nothing visible and no
    current token gives 0, as the port's plain version."""
    x, layer, _ = _reference("mixed", "k2", True)
    H, K = x["q"].shape[1], x["kn"].shape[1]
    got = _split(x, layer, "mixed", n_split)
    np.testing.assert_allclose(got[0].numpy(),
                               np.repeat(x["vn"][0], H // K, 0), rtol=1e-6,
                               atol=1e-6)
    bare = _split(x, layer, "mixed", n_split, with_new=False)
    assert not bare[0].any()
    plain = PA.paged_decode_attention_ref(
        _t(x["q"]), _t(x["kp"][layer]), _t(x["vp"][layer]), _t(x["pt"]),
        _t(x["lens"]))
    np.testing.assert_allclose(bare.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("n_split", [2, 3])
def test_dropped_split_is_a_fault_the_tolerance_rejects(n_split):
    """A merge that leaves one split of the long row out is far outside
    the tolerance: the planted fault of the card checks."""
    x, layer, want = _reference("mixed", "k1", True)
    bad = _split(x, layer, "mixed", n_split, drop_split=n_split - 1)
    assert np.abs(bad.numpy() - want)[3].max() > 100 * TOL


# ---------------------------------------------------------------- the plans
def test_split_plan_reads_the_shapes_only():
    """K1 (planes (L, NF, K, P, hd), any layer) and K2 (frames (NP, K, P,
    hd)) get one plan: the planes' depth and frame count and the layer are
    no argument of it, and no length is either."""
    params = set(inspect.signature(PA.paged_split_plan).parameters)
    assert params == {"cfg", "B", "K", "G", "P", "hd", "n_pages", "sms",
                      "n_split"}
    cfg = PULConfig(distance=4)
    want = PA.split_plan_for(cfg, (8, 16, 128), (516, 8, 16, 128), 64, 132)
    for planes in [(28, 516, 8, 16, 128), (1, 516, 8, 16, 128),
                   (6, 1000, 8, 16, 128), (516, 8, 16, 128),
                   (12, 8, 16, 128)]:
        assert PA.split_plan_for(cfg, (8, 16, 128), planes, 64, 132) == want
    assert (want.n_split, want.pages_per_split, want.distance,
            want.slots) == (8, 8, 4, 8)


@pytest.mark.parametrize("B,K,n_pages,sms,want", [
    (8, 8, 64, 132, 8),      # the smoke's decode: 528 / 64 blocks
    (1, 8, 64, 132, 64),     # one row: every page its own split
    (1, 1, 16, 132, 16),     # capped at the pages
    (64, 8, 64, 132, 1),     # a full grid already
    (8, 8, 64, 78, 4),       # a smaller card
])
def test_split_plan_aims_at_blocks_per_sm(B, K, n_pages, sms, want):
    plan = PA.paged_split_plan(PULConfig(), B=B, K=K, G=2, P=16, hd=128,
                               n_pages=n_pages, sms=sms)
    assert plan.n_split == want
    assert plan.pages_per_split == -(-n_pages // want)
    assert plan.distance <= plan.pages_per_split


@pytest.mark.parametrize("G", [1, 2, 5, 8, 16])
@pytest.mark.parametrize("hd", list(range(16, 257, 16)))
def test_split_plan_fits_shared_memory_and_the_wait_table(hd, G):
    for distance in (1, 4, 21, 64):
        for strategy in IssueStrategy:
            for n_split in (1, 8, None):
                plan = PA.paged_split_plan(
                    PULConfig(distance=distance, strategy=strategy), B=8,
                    K=8, G=G, P=16, hd=hd, n_pages=64, n_split=n_split)
                seq = strategy is IssueStrategy.SEQUENTIAL
                ring = plan.slots * 2 * 16 * hd * 2
                aux = PA.PAGED_WARPS * G * (hd + 2) * 4
                assert plan.smem_bytes == ring + aux <= PA.SMEM_LIMIT_BYTES
                assert 1 <= plan.distance <= min(PA.MAX_RING_DISTANCE,
                                                 plan.pages_per_split,
                                                 distance)
                assert plan.slots >= plan.distance + seq


@pytest.mark.parametrize("rows_per_req", [1, 16, 20000])
@pytest.mark.parametrize("row_bytes", [16, 1024, 6912, 114688])
def test_gather_bulk_plan_fits_shared_memory_and_the_wait_table(rows_per_req,
                                                                row_bytes):
    span = rows_per_req * row_bytes
    for distance in (1, 4, 28, 64):
        for strategy in IssueStrategy:
            plan = gather_bulk_plan(
                PULConfig(distance=distance, strategy=strategy),
                rows_per_req=rows_per_req, row_bytes=row_bytes)
            seq = strategy is IssueStrategy.SEQUENTIAL
            assert plan.smem_bytes == plan.slots * (plan.chunk_bytes + 8)
            assert plan.smem_bytes <= PA.SMEM_LIMIT_BYTES
            assert 1 <= plan.distance <= min(PA.MAX_RING_DISTANCE, distance)
            # the preload ring's slots and the store's (unload_distance 1)
            assert plan.slots >= plan.distance + seq + 1
            assert plan.chunk_bytes % 16 == 0
            assert (plan.n_chunks - 1) * plan.chunk_bytes < span
            assert plan.n_chunks * plan.chunk_bytes >= span
