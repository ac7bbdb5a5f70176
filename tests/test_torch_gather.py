"""The port's PUL gather K5 (repro_torch.kernels.pul_gather) vs the reference.

On the CPU each wrapper takes its plain version; the same numpy inputs go
through the reference's Pallas kernels in interpret mode (the shapes of
tests/test_kernels.py). A gather moves values without arithmetic, so the
comparison is bitwise (raw bits for bf16). The CUDA kernel itself runs only
on the card (tests/test_torch_cuda.py); its ring plan and grid split are
plain Python and are checked here at the serving geometries.
"""
import importlib
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IssueStrategy as RefIssueStrategy
from repro.core import PULConfig as RefPULConfig
from repro.kernels.pul_gather import pul_gather as ref_gather
from repro.kernels.pul_gather import pul_page_gather as ref_page_gather
from repro_torch.core import IssueStrategy, PULConfig
from repro_torch.kernels.pul_gather import (
    gather_ref,
    gather_ring_plan,
    page_gather_ref,
    pul_gather,
    pul_page_gather,
    run_length,
)

# the module (the package exports the function pul_attention under its name)
PA = importlib.import_module("repro_torch.kernels.pul_attention")

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16),
          "int32": (np.int32, jnp.int32, torch.int32)}


def _table(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    np_t, jnp_t, torch_t = DTYPES[dtype]
    if np_t is np.int32:
        x = rng.integers(-100, 100, size=shape).astype(np.int32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp_t), torch.from_numpy(x).to(torch_t)


def _bits(x):
    """Raw bits of a jax or torch array, as numpy."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if x.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("strategy", ["batch", "seq"])
@pytest.mark.parametrize("distance", [1, 2, 8])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_plain_matches_reference_kernel(dtype, distance, strategy):
    R, W, n = 64, 256, 40
    jt, tt = _table(dtype, (R, W))
    trace = np.random.default_rng(2).integers(0, R, size=n).astype(np.int32)
    seq = strategy == "seq"
    want = ref_gather(jt, jnp.asarray(trace), cfg=RefPULConfig(
        distance=distance, strategy=(RefIssueStrategy.SEQUENTIAL if seq
                                     else RefIssueStrategy.BATCH)))
    got = pul_gather(tt, torch.from_numpy(trace), cfg=PULConfig(
        distance=distance, strategy=(IssueStrategy.SEQUENTIAL if seq
                                     else IssueStrategy.BATCH)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got), _bits(gather_ref(tt, torch.from_numpy(trace))))


def test_gather_rows_per_request_matches_reference_kernel():
    jt, tt = _table("bf16", (64, 256))
    trace = np.random.default_rng(4).integers(0, 16, size=10).astype(np.int32)
    want = ref_gather(jt, jnp.asarray(trace), cfg=RefPULConfig(distance=3),
                      rows_per_req=4)
    got = pul_gather(tt, torch.from_numpy(trace), cfg=PULConfig(distance=3),
                     rows_per_req=4)
    assert got.shape == (40, 256)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="whole requests"):
        pul_gather(tt, torch.from_numpy(trace), rows_per_req=3)


@pytest.mark.parametrize("distance", [1, 4])
@pytest.mark.parametrize("P", [8, 16])
def test_page_gather_plain_matches_reference_kernel(P, distance):
    NP, F = 12, 128
    jt, tt = _table("f32", (NP, P, F), seed=1)
    pt = np.random.default_rng(11).integers(0, NP, size=(3, 4)).astype(np.int32)
    pt[2, 2:] = 0                     # past a slot's end: the zero frame
    want = ref_page_gather(jt, jnp.asarray(pt),
                           cfg=RefPULConfig(distance=distance))
    got = pul_page_gather(tt, torch.from_numpy(pt),
                          cfg=PULConfig(distance=distance))
    assert got.shape == (3, 4 * P, F)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got), _bits(page_gather_ref(tt, torch.from_numpy(pt))))


# ---------------------------------------------------------------- ring plan
# full-width qwen3-1.7b: F = 28 layers x 2 x 8 kv heads x 128 = 57,344 bf16
# features (114,688 B a row), 16-token pages; deepseek-v2 at the smoke's six
# layers: F = 6 x (512 + 64) = 3,456 (6,912 B a row)
QWEN3_ROW, DEEPSEEK_ROW = 57344 * 2, 3456 * 2


@pytest.mark.parametrize("row_bytes,distance,strategy,want", [
    # 1 KB of each of 16 rows per slot: 14 slots of 16 KB fit 227 KB
    (QWEN3_ROW, 4, IssueStrategy.BATCH, (4, 8, 1024, 112)),
    (QWEN3_ROW, 4, IssueStrategy.SEQUENTIAL, (4, 5, 1024, 112)),
    (QWEN3_ROW, 21, IssueStrategy.BATCH, (14, 14, 1024, 112)),
    (QWEN3_ROW, 64, IssueStrategy.SEQUENTIAL, (13, 14, 1024, 112)),
    # deepseek's planner d* = 28 clamps to 14; 6.75 tiles -> 7, the last
    # 768 B wide
    (DEEPSEEK_ROW, 28, IssueStrategy.BATCH, (14, 14, 1024, 7)),
], ids=["qwen3-d4", "qwen3-d4-seq", "qwen3-d21", "qwen3-d64-seq",
        "deepseek-d28"])
def test_gather_ring_plan_clamps_at_serving_geometries(row_bytes, distance,
                                                       strategy, want):
    plan = gather_ring_plan(PULConfig(distance=distance, strategy=strategy),
                            rows_per_req=16, row_bytes=row_bytes)
    assert (plan.distance, plan.slots, plan.tile_bytes, plan.n_tiles) == want
    assert plan.smem_bytes == plan.slots * 16 * plan.tile_bytes
    assert plan.smem_bytes <= PA.SMEM_LIMIT_BYTES


def test_gather_ring_plan_small_rows_clamp_to_wait_table():
    plan = gather_ring_plan(PULConfig(distance=64), rows_per_req=1,
                            row_bytes=1024)
    assert (plan.distance, plan.slots) == (PA.MAX_RING_DISTANCE,
                                           2 * PA.MAX_RING_DISTANCE)
    assert plan.tile_bytes == 1024 and plan.n_tiles == 1


@pytest.mark.parametrize("row_bytes", [0, 8, 100, 1000])
def test_gather_ring_plan_rejects_rows_off_the_granule(row_bytes):
    with pytest.raises(ValueError, match="16-byte cp.async granules"):
        gather_ring_plan(PULConfig(), rows_per_req=16, row_bytes=row_bytes)


def test_gather_ring_plan_rejects_a_slab_beyond_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        gather_ring_plan(PULConfig(distance=1), rows_per_req=20000,
                         row_bytes=1024)


@pytest.mark.parametrize("n_req,n_tiles,distance,want", [
    (512, 112, 4, 103),     # qwen3 smoke: 5 runs x 112 tiles = 560 blocks
    (512, 7, 14, 27),       # deepseek: 19 runs of >= 2 ring depths
    (40, 1, 8, 14),         # the reference test shape
    (3, 1, 8, 3),           # fewer requests than a ring depth
])
def test_run_length_fills_the_card_and_the_ring(n_req, n_tiles, distance, want):
    assert run_length(n_req, n_tiles, distance, sms=132) == want


def test_gather_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on CUDA is refused: only CPU
    tensors take the plain version."""
    table = torch.empty((16, 64), device="meta")
    trace = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pul_gather(table, trace)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pul_page_gather(table.reshape(2, 8, 64), trace.reshape(2, 2))
