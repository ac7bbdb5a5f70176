"""The plans of K10's and K7's register-tiled f32 bodies, on the CPU: the
thread and warp tiles at every tile or head dim they take, their rings
within Hopper's shared memory at every distance and issue order, and the
host's constants equal to their CUDA sources'.

The bodies themselves run only on the card (tests/test_torch_cuda.py,
marker ``cuda``); here the plain versions stand in for them, as everywhere
on the CPU.
"""
import importlib
import re
from pathlib import Path

import pytest
import torch

from repro_torch.core import IssueStrategy, PULConfig
from repro_torch.kernels._runtime import SMEM_LIMIT_BYTES
from repro_torch.kernels.pul_matmul import (
    FMA_BODY,
    FMA_CHUNK,
    TILES,
    matmul_body,
    matmul_fma_block_n,
    matmul_fma_tiles,
    matmul_ring_plan,
)

# the module (the package exports the function pul_attention under its name)
PA = importlib.import_module("repro_torch.kernels.pul_attention")
CSRC = Path(PA.__file__).resolve().parent.parent / "csrc"
RINGS = [(d, s) for d in (1, 2, 4, 8) for s in IssueStrategy]
RING_IDS = [f"d{d}-{s.name.lower()}" for d, s in RINGS]


# ------------------------------------------------------------------ K10
@pytest.mark.parametrize("bn", TILES)
@pytest.mark.parametrize("bm", TILES)
def test_matmul_fma_tiles_cover_the_block(bm, bn):
    """A thread's TM x TN outputs are (TM / 4) x (TN / 4) sub-tiles of 4 x
    4 (8 where the side is 128), a warp's 8 x 4 lanes cover 8 TM x 4 TN, and
    the block's warps cover bm x bn once."""
    t = matmul_fma_tiles(bm, bn)
    tm, tn = t.thread
    assert (tm, tn) == (8 if bm == 128 else 4, 8 if bn == 128 else 4)
    _check_cover(bm, bn, t)


def _check_cover(bm, bn, t):
    tm, tn = t.thread
    assert tm % 4 == 0 and tn % 4 == 0
    assert t.warp == (8 * tm, 4 * tn)
    assert bm % t.warp[0] == 0 and bn % t.warp[1] == 0
    assert t.threads == 32 * (bm // t.warp[0]) * (bn // t.warp[1])
    assert t.threads * tm * tn == bm * bn
    assert t.threads in (64, 128, 256)


def test_matmul_fma_tiles_at_the_default_block():
    """The default 128 x 128 f32 tiles pair up where N allows: a 128 x 256
    block of 8 x 16 thread tiles; one tile a block otherwise, and for bf16
    (whose 128 x 128 tiles run on the tensor cores)."""
    assert matmul_fma_block_n(torch.float32, 128, 128, 2048) == 256
    assert matmul_fma_block_n(torch.float32, 128, 128, 384) == 128
    assert matmul_fma_block_n(torch.float32, 64, 64, 2048) == 64
    assert matmul_fma_block_n(torch.bfloat16, 32, 128, 2048) == 128
    t = matmul_fma_tiles(128, 256)
    assert (t.thread, t.warp, t.threads) == ((8, 16), (64, 64), 256)
    _check_cover(128, 256, t)
    t = matmul_fma_tiles(128, 128)
    assert (t.thread, t.warp, t.threads) == ((8, 8), (64, 32), 256)
    with pytest.raises(ValueError, match="built"):
        matmul_fma_tiles(48, 128)
    with pytest.raises(ValueError, match="built"):
        matmul_fma_tiles(64, 256)


#: the CUDA-core body's blocks: every (bm, bn) tile, and two 128 x 128 f32
#: tiles side by side
FMA_BLOCKS = [(bm, bn) for bm in TILES for bn in TILES] + [(128, 256)]


@pytest.mark.parametrize("ring", RINGS, ids=RING_IDS)
@pytest.mark.parametrize("bm,bn", FMA_BLOCKS)
def test_matmul_fma_plan_fits_at_every_tile_and_ring(bm, bn, ring):
    """Chunks of FMA_CHUNK K values, A's rows padded by a granule; slots
    and distance from PULConfig within 227 KB, slots >= d (+1 under
    SEQUENTIAL), f32 and the bf16 inputs the body takes at bm = 32."""
    d, strategy = ring
    cfg = PULConfig(distance=d, strategy=strategy)
    seq = strategy is IssueStrategy.SEQUENTIAL
    for itemsize in (4, 2) if bm == 32 and bn <= 128 else (4,):
        plan = matmul_ring_plan(cfg, bm=bm, bk=128, bn=bn, itemsize=itemsize)
        slot = (bm + bn + 4) * FMA_CHUNK * itemsize
        assert plan.bk_chunk == FMA_CHUNK
        assert plan.smem_bytes == plan.slots * slot <= SMEM_LIMIT_BYTES
        assert 1 <= plan.distance <= d
        assert plan.slots >= plan.distance + seq
        want = d + 1 if seq else 2 * d
        if want * slot <= SMEM_LIMIT_BYTES:
            assert (plan.distance, plan.slots) == (d, want)


def test_matmul_fma_plan_refuses_k_tiles_not_whole_chunks():
    for bk in (8, 24, 40):
        with pytest.raises(ValueError, match="chunks of 16"):
            matmul_ring_plan(PULConfig(), bm=64, bk=bk, bn=64, itemsize=4)


@pytest.mark.parametrize("dtype,bm", [(torch.float32, 32), (torch.float32, 64),
                                      (torch.float32, 128),
                                      (torch.bfloat16, 32)])
def test_matmul_fma_body_is_the_cuda_core_route(dtype, bm):
    for bn in TILES:
        assert matmul_body(dtype, bm, bn) == FMA_BODY == "fma-tiled"


def test_matmul_host_constants_are_the_source_constants():
    """The host plans with the source's chunk depth and tile rule."""
    src = (CSRC / "pul_matmul.cu").read_text()
    assert f"constexpr int kFmaChunk = {FMA_CHUNK};" in src
    assert "kTM = BM == 128 ? 8 : 4;" in src
    assert "kTN = BN == 256 ? 16 : BN == 128 ? 8 : 4;" in src
    assert "bm == 128 && bn == 128 && N % 256 == 0 ? 256 : bn" in src
    assert "kWM = 8 * kTM;" in src and "kWN = 4 * kTN;" in src
    assert "AS = BM + 4;" in src        # A^T's rows padded by a granule


# ------------------------------------------------------------------- K7
@pytest.mark.parametrize("hd", PA.DENSE_HDS)
def test_attention_f32_tiles_cover_the_block(hd):
    """A block's rows split over 8 warps; a warp's S lanes (4 row groups x
    8 key groups) cover its rows x the 32 keys of a chunk, and its O lanes
    cover its rows x hd once, in sub-tiles of 4 x 4."""
    t = PA.attention_f32_tiles(hd)
    keys = PA.kv_chunk_rows(4)
    assert keys == 32
    assert t.rows == (64 if hd == 256 else PA.Q_ROWS)
    assert t.s_warp == (t.rows // 8, keys)
    assert t.s_thread == (t.rows // 32, keys // 8)
    assert 32 * t.s_thread[0] * t.s_thread[1] == t.s_warp[0] * t.s_warp[1]
    tro, tdo = t.o_thread
    assert tro % 4 == 0 and tdo % 4 == 0 and hd % tdo == 0
    assert t.o_threads <= 256 and t.o_threads % 8 == 0
    assert t.o_threads * tro * tdo == t.rows * hd
    assert (t.o_threads // 8) * tro * tdo == t.s_warp[0] * hd


def test_attention_f32_tiles_at_the_smoke_case():
    t = PA.attention_f32_tiles(128)
    assert (t.rows, t.s_thread, t.s_warp, t.o_thread, t.o_threads) == (
        128, (4, 4), (16, 32), (8, 8), 256)


@pytest.mark.parametrize("ring", RINGS, ids=RING_IDS)
@pytest.mark.parametrize("hd", PA.DENSE_HDS)
def test_attention_f32_plan_fits_at_every_head_dim_and_ring(hd, ring):
    """q rows, their sums and each warp's transposed probabilities and
    rescale factors beside the ring, within 227 KB; slots >= d (+1 under
    SEQUENTIAL); the whole PULConfig ring where it fits."""
    d, strategy = ring
    cfg = PULConfig(distance=d, strategy=strategy)
    seq = strategy is IssueStrategy.SEQUENTIAL
    plan = PA.attention_ring_plan(cfg, hd=hd)
    rows = PA.attention_f32_tiles(hd).rows
    aux = (rows * (hd + 4) + rows + 8 * (32 * (rows // 8 + 4) + rows // 8)) * 4
    slot = PA.kv_slot_bytes(hd, 4)
    assert plan.smem_bytes == plan.slots * slot + aux <= SMEM_LIMIT_BYTES
    assert 1 <= plan.distance <= d
    assert plan.slots >= plan.distance + seq
    want = d + 1 if seq else 2 * d
    if want * slot + aux <= SMEM_LIMIT_BYTES:
        assert (plan.distance, plan.slots) == (d, want)


def test_attention_host_constants_are_the_source_constants():
    """The host plans with the source's rows, warps and chunk."""
    src = (CSRC / "pul_dense_attention.cu").read_text()
    assert "kBR = HD == 256 ? 64 : 128;" in src
    assert PA.Q_ROWS == 128 and PA.F32_WARPS == 8
    assert "constexpr int kWarps = kThreads / 32;" in src
    assert re.search(r"using F32Chunk = Ring<float, HD, 32>;", src)
    assert "kTDO = HD >= 112 ? 8 : 4;" in src
    assert PA.attention_body(torch.float32) == PA.F32_BODY == "fma-tiled"
