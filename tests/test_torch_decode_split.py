"""K6's split-KV design (repro_torch.kernels.pul_decode) vs the reference.

The card runs K6 as a split kernel over segments of the chunks every row
streams (balanced over the grid from the lengths, or forced) and a merge
kernel. :func:`decode_attention_split_ref` is that arithmetic in plain fp32
PyTorch, cut as :func:`decode_pieces` cuts; here it is held against the
reference's Pallas kernel in interpret mode, at G 1, 2, 5 and 16, with and
without the softcap, in f32 and bf16 inputs, on rows of length 0, 1, one
chunk, one chunk and a key, two chunks (a segment's end when segments are
two chunks) and S, within the tolerances of tests/test_torch_attention.py
(K6 3e-4 in f32, 2e-2 in bf16). A piece left out of the merge falls
outside them. The cut itself is plain Python and is checked here.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PULConfig as RefPULConfig
from repro.kernels.pul_decode import pul_decode_attention as ref_k6
from repro_torch.core import PULConfig
from repro_torch.kernels.pul_decode import (
    decode_attention_kernel_ref,
    decode_attention_split_ref,
    decode_chunk_keys,
    decode_pieces,
    decode_ring_plan,
)

DTYPES = {"f32": (jnp.float32, torch.float32, 3e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
K, S, HD = 2, 600, 32


def _lengths(dtype):
    ck = decode_chunk_keys(HD, DTYPES[dtype][1].itemsize, 2)
    return [0, 1, ck, ck + 1, 2 * ck, S]


@functools.lru_cache(maxsize=None)
def _case(dtype, G, softcap):
    """Inputs (torch) and the reference kernel's out (interpret mode)."""
    jt, tt, _ = DTYPES[dtype]
    lengths = _lengths(dtype)
    B = len(lengths)
    rng = np.random.default_rng(G + 7 * (softcap is not None))
    q = (rng.standard_normal((B, K * G, HD)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((B, K, S, HD)) * 0.4).astype(np.float32)
    v = rng.standard_normal((B, K, S, HD)).astype(np.float32)
    length = np.asarray(lengths, np.int32)
    want = ref_k6(*(jnp.asarray(x).astype(jt) for x in (q, k, v)),
                  jnp.asarray(length), cfg=RefPULConfig(distance=2),
                  softcap=softcap)
    return ([torch.from_numpy(x).to(tt) for x in (q, k, v)],
            torch.from_numpy(length), np.asarray(want, np.float32))


@pytest.mark.parametrize("seg_chunks", [None, 1, 2])
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("G", [1, 2, 5, 16])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_model_matches_reference_kernel(dtype, G, softcap, seg_chunks):
    (q, k, v), length, want = _case(dtype, G, softcap)
    got = decode_attention_split_ref(q, k, v, length, softcap=softcap,
                                     seg_chunks=seg_chunks)
    assert got.dtype == q.dtype
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("seg_chunks", [1, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_a_piece_left_out_of_the_merge_is_rejected(dtype, seg_chunks):
    (q, k, v), length, want = _case(dtype, 2, None)
    bad = decode_attention_split_ref(q, k, v, length, seg_chunks=seg_chunks,
                                     drop_piece=1)
    tol = DTYPES[dtype][2]
    assert not np.allclose(bad.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("sms", [1, 3, 132])
def test_split_model_at_balanced_segments_matches_the_plain_version(sms):
    """The cut the card balances over 1, 3 or 132 SMs (three blocks each)
    changes only the order of the sums."""
    (q, k, v), length, _ = _case("f32", 5, 5.0)
    want = decode_attention_kernel_ref(q, k, v, length, softcap=5.0)
    got = decode_attention_split_ref(q, k, v, length, softcap=5.0, sms=sms)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("sms", [1, 4, 132])
@pytest.mark.parametrize("seg_chunks", [None, 1, 3, 1000])
def test_pieces_cover_every_row_and_fit_their_slots(seg_chunks, sms):
    """Each (b, kv head) row's pieces tile [0, its chunks) in order, no row
    has more than n_piece, and every segment but the last is whole."""
    plan = decode_ring_plan(PULConfig(), B=6, K=4, G=2, s_pad=4096,
                            hd=128, itemsize=2, sms=sms,
                            seg_chunks=seg_chunks)
    lengths = [4096, 0, 1, 63, 65, 2000]
    seg, pieces = decode_pieces(plan, lengths, 4)
    ck = plan.chunk_keys
    assert seg == (seg_chunks or max(plan.min_seg, -(-sum(
        4 * (-(-n // ck) if n else plan.n_chunks) for n in lengths)
        // plan.grid)))
    start = 0
    for b, n in enumerate(lengths):
        vis = -(-n // plan.chunk_keys) if n else plan.n_chunks
        for kvh in range(4):
            cuts = pieces[b, kvh]
            assert cuts[0][0] == 0 and cuts[-1][1] == vis
            assert all(c1 == c0 for (_, c1), (c0, _) in zip(cuts, cuts[1:]))
            assert all(0 < c1 - c0 <= seg for c0, c1 in cuts)
            assert len(cuts) <= plan.n_piece
            # a piece ends at a segment's end or the row's
            for c0, c1 in cuts[:-1]:
                assert (start + c1) % seg == 0
            start += vis
    assert plan.n_piece >= 2


def test_balanced_segments_at_the_smoke_case_keep_every_block_busy():
    """At the smoke's lengths the balanced cut gives one segment to all but
    a few of the 396 blocks, none past the chunks that exist."""
    plan = decode_ring_plan(PULConfig(), B=8, K=8, G=2, s_pad=32768)
    lengths = (32768, 30000, 16384, 8193, 4096, 1000, 129, 1)
    seg, pieces = decode_pieces(plan, lengths, 8)
    total = sum(c1 - c0 for cuts in pieces.values() for c0, c1 in cuts)
    assert total == 8 * sum(-(-n // plan.chunk_keys) for n in lengths)
    n_segs = -(-total // seg)
    assert 0.95 * plan.grid <= n_segs <= plan.grid
