"""The port's dense attention K6/K7 (repro_torch.kernels.pul_decode,
pul_attention) vs the reference.

On the CPU each wrapper takes its plain version; the same numpy inputs go
through the reference's Pallas kernels in interpret mode, at the shapes and
tolerances of tests/test_kernels.py (f32 2e-4, bf16 2e-2, the uneven KV
tail and K6 3e-4). Three quirks of the reference's kernels, where they part
from its own oracles, are pinned against the kernels: the window applies
without causal, and a row that sees no key (K6 at length 0, K7 with T > S)
gets the sum of its v rows over the padded stream. The CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PULConfig as RefPULConfig
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels.pul_attention import pul_attention as ref_k7
from repro.kernels.pul_decode import pul_decode_attention as ref_k6
from repro_torch.core import IssueStrategy, PULConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels._runtime import SMEM_LIMIT_BYTES
from repro_torch.kernels.pul_attention import (
    DENSE_HDS,
    TC_ROWS,
    attention_body,
    attention_kernel_ref,
    attention_ring_plan,
    attention_tc_plan,
    pul_attention,
)
from repro_torch.kernels.pul_decode import (
    DECODE_CHUNK_BYTES,
    DECODE_SMEM_BYTES,
    decode_attention_kernel_ref,
    decode_chunk_keys,
    decode_pieces,
    decode_ring_plan,
    pul_decode_attention,
)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
TOL = 3e-4


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(x, dtype):
    """The same values as a jax array and a torch tensor of one type (both
    round f32 to bf16 to nearest even)."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _qkv(seed, B, H, K, T, S, hd, dtype, qs=0.3, ks=0.3):
    rng = np.random.default_rng(seed)
    return [_both(x, dtype) for x in (_rand(rng, (B, H, T, hd), qs),
                                      _rand(rng, (B, K, S, hd), ks),
                                      _rand(rng, (B, K, S, hd)))]


# ------------------------------------------------------------------ K7
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("gqa", [1, 4])
@pytest.mark.parametrize("softcap,window", [(None, None), (8.0, None),
                                            (None, 24)])
def test_attention_plain_matches_reference_kernel(dtype, gqa, softcap, window):
    """tests/test_kernels.py::test_pul_attention's 12 cases."""
    B, K, T, S, hd = 2, 2, 64, 64, 32
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, B, K * gqa, K, T, S, hd, dtype)
    want = ref_k7(jq, jk, jv, cfg=RefPULConfig(distance=2), bt=32, bs=16,
                  softcap=softcap, window=window)
    got = pul_attention(tq, tk, tv, cfg=PULConfig(distance=2), bt=32, bs=16,
                        softcap=softcap, window=window)
    assert got.dtype == tq.dtype
    _close(got, want, DTYPES[dtype][2])


def test_attention_plain_matches_reference_kernel_uneven_kv_tail():
    """S = 48 over bs = 32 blocks: the stream's tail past S is masked."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 1, 2, 2, 32, 48, 16, "f32",
                                        qs=0.5, ks=0.5)
    want = ref_k7(jq, jk, jv, bt=32, bs=32)
    _close(pul_attention(tq, tk, tv, bt=32, bs=32), want, TOL)


@pytest.mark.parametrize("softcap", [None, 8.0])
def test_attention_window_applies_without_causal(softcap):
    """Quirk: the reference's K7 masks jk > iq - window even when
    causal=False (its oracle only under causal); the port follows the
    kernel."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 2, 4, 2, 64, 64, 32, "f32")
    kw = dict(causal=False, softcap=softcap, window=24)
    want = ref_k7(jq, jk, jv, bt=32, bs=16, **kw)
    got = pul_attention(tq, tk, tv, bt=32, bs=16, **kw)
    _close(got, want, TOL)
    oracle = ref.attention_ref(tq, tk, tv, **kw)
    assert not np.allclose(got.numpy(), oracle.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bs", [16, 40])
def test_attention_rows_before_the_keys_see_the_padded_stream(bs):
    """Quirk: with T > S the first T - S rows (iq < 0) see no key; the
    kernel weighs every position of the padded stream by exp(0) = 1, so
    they get sum(v) / s_pad (the oracle's softmax gives the mean over S)."""
    T, S = 64, 48
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 1, 4, 2, T, S, 16, "f32")
    want = ref_k7(jq, jk, jv, bt=32, bs=bs)
    got = pul_attention(tq, tk, tv, bt=32, bs=bs)
    _close(got, want, TOL)
    s_pad = -(-S // bs) * bs
    blind = tv.sum(dim=2, keepdim=True).repeat_interleave(2, dim=1) / s_pad
    _close(got[:, :, :T - S], blind.expand(-1, -1, T - S, -1).numpy(), TOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kw", [dict(), dict(softcap=20.0, window=40),
                                dict(causal=False)],
                         ids=["causal", "softcap+window", "full"])
def test_attention_op_matches_reference_op(dtype, kw):
    """ops.attention_op at its default tiles (bt = bs = 128) against the
    reference's, which interprets its kernel on the CPU."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(4, 1, 4, 2, 64, 160, 32, dtype)
    want = ref_ops.attention_op(jq, jk, jv, **kw)
    _close(ops.attention_op(tq, tk, tv, **kw), want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kw", [dict(), dict(softcap=8.0, window=24),
                                dict(causal=False, window=24)],
                         ids=["causal", "softcap+window", "window-no-causal"])
def test_attention_oracle_matches_reference_oracle(dtype, kw):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(5, 2, 4, 2, 48, 64, 16, dtype)
    want = ref_oracles.attention_ref(jq, jk, jv, **kw)
    _close(ref.attention_ref(tq, tk, tv, **kw), want, DTYPES[dtype][2])


def test_attention_kernel_ref_is_the_oracle_where_both_see_keys():
    """Without the quirks (T <= S, window only under causal) the kernel's
    plain version and the oracle compute one function."""
    (_, tq), (_, tk), (_, tv) = _qkv(6, 2, 8, 2, 32, 80, 32, "f32")
    for kw in (dict(), dict(softcap=8.0, window=17), dict(causal=False)):
        _close(attention_kernel_ref(tq, tk, tv, bs=32, **kw),
               ref.attention_ref(tq, tk, tv, **kw).numpy(), 1e-5)


def test_attention_checks_raise():
    q, k = torch.zeros(1, 4, 48, 16), torch.zeros(1, 2, 48, 16)
    with pytest.raises(ValueError, match="whole blocks"):
        pul_attention(q, k, k, bt=32)
    with pytest.raises(ValueError, match="kv heads"):
        pul_attention(q, torch.zeros(1, 3, 48, 16), torch.zeros(1, 3, 48, 16))
    with pytest.raises(ValueError, match="window"):
        pul_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="softcap"):
        pul_attention(q, k, k, softcap=0.0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G", [5, 6])
@pytest.mark.parametrize("hd", [16, 64, 256])
def test_attention_plain_matches_reference_kernel_at_zoo_shapes(hd, G, dtype):
    """The head dims of the reduced configs (16), musicgen (64) and gemma3
    (256), and the groups of qwen2.5-32b (5) and grok (6), which the card
    kernel takes: the plain version against the reference's kernel."""
    B, K, T, S = 1, 2, 32, 48
    (jq, tq), (jk, tk), (jv, tv) = _qkv(10 + hd + G, B, K * G, K, T, S, hd,
                                        dtype)
    kw = dict(softcap=8.0) if G == 5 else dict(window=20)
    want = ref_k7(jq, jk, jv, cfg=RefPULConfig(distance=2), bt=16, bs=16,
                  **kw)
    got = pul_attention(tq, tk, tv, cfg=PULConfig(distance=2), bt=16, bs=16,
                        **kw)
    assert got.dtype == tq.dtype
    _close(got, want, DTYPES[dtype][2])


# ------------------------------------------------------------------ K6
@pytest.mark.parametrize("gqa", [1, 4])
@pytest.mark.parametrize("distance", [1, 4])
@pytest.mark.parametrize("softcap", [None, 10.0])
def test_decode_plain_matches_reference_kernel(gqa, distance, softcap):
    """tests/test_kernels.py::test_pul_decode_attention's 8 cases."""
    B, K, S, hd = 2, 2, 96, 32
    rng = np.random.default_rng(7)
    q = _rand(rng, (B, K * gqa, hd), 0.4)
    k = _rand(rng, (B, K, S, hd), 0.4)
    v = _rand(rng, (B, K, S, hd))
    length = np.asarray([S, S // 2], np.int32)
    want = ref_k6(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(length), cfg=RefPULConfig(distance=distance),
                  bs=32, softcap=softcap)
    got = pul_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(length), cfg=PULConfig(distance=distance), bs=32,
        softcap=softcap)
    _close(got, want, TOL)


def test_decode_length_zero_sees_the_padded_stream():
    """Quirk: a row of length 0 sees nothing; over S = 80 in bs = 32 blocks
    the kernel gives sum(v) / 96, the oracle the mean over 80."""
    B, K, G, S, hd = 2, 2, 2, 80, 16
    rng = np.random.default_rng(8)
    q, k, v = (_rand(rng, (B, K * G, hd), 0.4), _rand(rng, (B, K, S, hd), 0.4),
               _rand(rng, (B, K, S, hd)))
    length = np.asarray([0, 50], np.int32)
    want = ref_k6(*map(jnp.asarray, (q, k, v, length)), bs=32)
    got = pul_decode_attention(*map(torch.from_numpy, (q, k, v, length)),
                               bs=32)
    _close(got, want, TOL)
    blind = v[0].sum(axis=1) / 96
    _close(got[0], np.repeat(blind, G, axis=0), TOL)
    oracle = ref.decode_attention_ref(*map(torch.from_numpy, (q, k, v, length)))
    assert not np.allclose(got[0].numpy(), oracle[0].numpy(), atol=TOL)


@pytest.mark.parametrize("softcap", [None, 10.0])
def test_decode_oracle_matches_reference_oracle(softcap):
    rng = np.random.default_rng(9)
    q, k, v = (_rand(rng, (3, 8, 16), 0.4), _rand(rng, (3, 2, 40, 16), 0.4),
               _rand(rng, (3, 2, 40, 16)))
    length = np.asarray([40, 17, 1], np.int32)
    want = ref_oracles.decode_attention_ref(*map(jnp.asarray, (q, k, v, length)),
                                            softcap=softcap)
    got = ref.decode_attention_ref(*map(torch.from_numpy, (q, k, v, length)),
                                   softcap=softcap)
    _close(got, want, TOL)
    # where every row sees a key, the kernel's plain version agrees
    _close(decode_attention_kernel_ref(*map(torch.from_numpy,
                                            (q, k, v, length)),
                                       softcap=softcap), want, TOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G", [5, 6])
@pytest.mark.parametrize("hd", [16, 64, 256])
def test_decode_plain_matches_reference_kernel_at_zoo_shapes(hd, G, dtype):
    B, K, S = 2, 2, 80
    rng = np.random.default_rng(20 + hd + G)
    q, k, v = (_rand(rng, (B, K * G, hd), 0.4), _rand(rng, (B, K, S, hd), 0.4),
               _rand(rng, (B, K, S, hd)))
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    length = np.asarray([S, 33], np.int32)
    softcap = 10.0 if G == 6 else None
    want = ref_k6(jq, jk, jv, jnp.asarray(length), bs=32, softcap=softcap)
    got = pul_decode_attention(tq, tk, tv, torch.from_numpy(length), bs=32,
                               softcap=softcap)
    assert got.dtype == tq.dtype
    _close(got, want, DTYPES[dtype][2])


# ---------------------------------------------------------- ring plans
@pytest.mark.parametrize("itemsize,slot", [(2, 34816), (4, 33792)])
@pytest.mark.parametrize("cfg,want", [
    (PULConfig(), (4, 4)),
    (PULConfig(distance=1), (1, 2)),
    (PULConfig(distance=4, strategy=IssueStrategy.SEQUENTIAL), (3, 4)),
    (PULConfig(distance=1, strategy=IssueStrategy.SEQUENTIAL), (1, 2)),
    (PULConfig(distance=16), (4, 4))], ids=["d4", "d1", "d4-seq", "d1-seq",
                                            "d16"])
def test_attention_ring_plan_fits_shared_memory(itemsize, slot, cfg, want):
    """K7 at hd = 128: 128 fp32 query rows (padded by a granule), their
    sums and each of the 8 warps' transposed probabilities of a 32-key
    chunk (16 rows, padded) and rescale factors beside the ring; d and
    slots clamp to what fits."""
    plan = attention_ring_plan(cfg, hd=128, itemsize=itemsize)
    assert (plan.distance, plan.slots) == want
    aux = (128 * 132 + 128 + 8 * (32 * 20 + 16)) * 4
    assert aux == 89088
    assert plan.smem_bytes == plan.slots * slot + aux
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES


@pytest.mark.parametrize("cfg", [PULConfig(), PULConfig(distance=1),
                                 PULConfig(distance=4,
                                           strategy=IssueStrategy.SEQUENTIAL)])
def test_decode_ring_plan_at_the_smoke_shape(cfg):
    """K6 at B = 8, K = 8, G = 2, S = 32768 bf16 on 132 SMs: chunks of 64
    keys (32 KB of K and V), the ring within a third of an SM's shared
    memory (three blocks an SM, one wave of 396), holding d; the smoke's
    lengths cut into balanced segments whose pieces cover each row's
    visible chunks, at most n_piece a row."""
    seq = cfg.strategy is IssueStrategy.SEQUENTIAL
    plan = decode_ring_plan(cfg, B=8, K=8, G=2, s_pad=32768, itemsize=2,
                            sms=132)
    assert plan.smem_bytes <= DECODE_SMEM_BYTES < SMEM_LIMIT_BYTES
    assert (plan.blocks_per_sm, plan.grid) == (3, 396)
    assert plan.slots >= plan.distance + seq
    assert plan.distance == min(cfg.distance, plan.slots - seq)
    assert (plan.chunk_keys, plan.n_chunks) == (64, 512)
    assert plan.n_chunks * plan.chunk_keys >= 32768
    lengths = (32768, 30000, 16384, 8193, 4096, 1000, 129, 1)
    seg, pieces = decode_pieces(plan, lengths, 8)
    total = 8 * sum(-(-n // 64) for n in lengths)
    assert seg == max(plan.min_seg, -(-total // plan.grid))
    for (b, _), cuts in pieces.items():
        assert cuts[0][0] == 0 and cuts[-1][1] == -(-lengths[b] // 64)
        assert all(c1 == c0 for (_, c1), (c0, _) in zip(cuts, cuts[1:]))
        assert len(cuts) <= plan.n_piece


def test_decode_ring_plan_small_cache_is_one_segment():
    """192 keys of f32 at hd 128 are 6 chunks of 32; a forced segment of
    the whole stream gives every row (whatever its length) one piece."""
    plan = decode_ring_plan(PULConfig(), B=2, K=2, G=4, s_pad=192,
                            itemsize=4, seg_chunks=6)
    assert (plan.chunk_keys, plan.n_chunks, plan.n_piece) == (32, 6, 2)
    _, pieces = decode_pieces(plan, [192, 0], 2)
    assert all(cuts == [(0, 6)] for cuts in pieces.values())
    _, pieces = decode_pieces(plan, [33, 192], 2)
    assert pieces[0, 0] == [(0, 2)] and pieces[1, 1] == [(0, 2), (2, 6)]


def test_dense_wrappers_refuse_other_devices_instead_of_falling_back():
    meta = torch.empty((1, 2, 32, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pul_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        pul_decode_attention(meta[:, :, 0], meta, meta, [3])


@pytest.mark.parametrize("strategy", list(IssueStrategy),
                         ids=lambda s: s.name.lower())
@pytest.mark.parametrize("distance", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", DENSE_HDS)
def test_attention_plans_fit_shared_memory_at_every_head_dim(hd, distance,
                                                             strategy):
    """K7's bf16 ring (TC_ROWS bf16 query rows beside chunks of 64 keys, 32
    at hd 256, rows padded by a granule) and its f32 ring fit 227 KB at
    every hd the kernels are built for, d and slots clamped to what fits."""
    cfg = PULConfig(distance=distance, strategy=strategy)
    seq = strategy is IssueStrategy.SEQUENTIAL
    row = 2 * hd + 16
    keys = 32 if hd == 256 else 64
    tc = attention_tc_plan(cfg, hd=hd)
    assert tc.smem_bytes == tc.slots * 2 * keys * row + TC_ROWS * row
    f32 = attention_ring_plan(cfg, hd=hd, itemsize=4)
    rows = 64 if hd == 256 else 128
    warp = 32 * (rows // 8 + 4) + rows // 8
    assert f32.smem_bytes == (f32.slots * 2 * 32 * (4 * hd + 16)
                              + (rows * (hd + 4) + rows + 8 * warp) * 4)
    for plan in (tc, f32):
        assert plan.smem_bytes <= SMEM_LIMIT_BYTES
        assert 1 <= plan.distance <= distance
        assert plan.slots >= plan.distance + seq
    want = distance + 1 if seq else 2 * distance
    if want * 2 * keys * row + TC_ROWS * row <= SMEM_LIMIT_BYTES:
        assert (tc.distance, tc.slots) == (distance, want)   # fits whole


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("hd", DENSE_HDS)
def test_decode_ring_plan_fits_at_every_head_dim(hd, itemsize):
    for G in (1, 5, 6, 16):
        for cfg in (PULConfig(), PULConfig(distance=8),
                    PULConfig(distance=4, strategy=IssueStrategy.SEQUENTIAL)):
            plan = decode_ring_plan(cfg, B=2, K=8, G=G, s_pad=4096, hd=hd,
                                    itemsize=itemsize)
            assert plan.smem_bytes <= DECODE_SMEM_BYTES
            assert plan.slots >= plan.distance >= 1
            assert plan.chunk_keys == decode_chunk_keys(hd, itemsize, G)
            assert 2 * plan.chunk_keys * hd * itemsize <= DECODE_CHUNK_BYTES
            assert plan.n_chunks * plan.chunk_keys >= 4096
            _, pieces = decode_pieces(plan, [4096, 1], 8)
            assert max(map(len, pieces.values())) <= plan.n_piece


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "mma.sync"),
                                        (torch.float32, "fma")])
def test_attention_body_follows_dtype(dtype, body):
    """bf16 runs on the tensor cores (mma.sync), f32 on the CUDA cores (the
    register-tiled fma body, "fma-tiled")."""
    assert attention_body(dtype) == {"fma": "fma-tiled"}.get(body, body)


@pytest.mark.parametrize("hd,G", [(16, 1), (32, 6), (64, 5), (112, 5),
                                  (128, 6), (256, 5), (256, 6)])
def test_dense_wrappers_take_every_zoo_shape_on_meta(hd, G):
    """Tensors on no device pass the checks of shape (head dim, group) and
    stop only at the device: the card kernels take these shapes."""
    q = torch.empty((1, 2 * G, 64, hd), device="meta")
    k = torch.empty((1, 2, 64, hd), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pul_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        pul_decode_attention(q[:, :, 0], k, k, [3])


def test_dense_wrappers_refuse_other_head_dims_and_groups_on_meta():
    q = torch.empty((1, 4, 64, 24), device="meta")
    k = torch.empty((1, 2, 64, 24), device="meta")
    with pytest.raises(ValueError, match="built for"):
        pul_attention(q, k, k)
    with pytest.raises(ValueError, match="built for"):
        pul_decode_attention(q[:, :, 0], k, k, [3])
    q17 = torch.empty((1, 34, 128), device="meta")
    k17 = torch.empty((1, 2, 64, 128), device="meta")
    with pytest.raises(ValueError, match="at most"):
        pul_decode_attention(q17, k17, k17, [3])
