"""The port's PUL gather K5 (repro_torch.kernels.pul_gather) vs the reference.

On the CPU each wrapper takes its plain version; the same numpy inputs go
through the reference's Pallas kernels in interpret mode (the shapes of
tests/test_kernels.py). A gather moves values without arithmetic, so the
comparison is bitwise (raw bits for bf16). The CUDA kernel itself runs only
on the card (tests/test_torch_cuda.py); its plan (chunks, ring) and grid
split are plain Python and are checked here at the serving geometries.
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
    CHUNK_BYTES,
    MBARRIER_BYTES,
    gather_bulk_plan,
    page_gather_ref,
    pul_gather,
    pul_page_gather,
    stream_runs,
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
    # a 1,835,008 B qwen3 page is 56 chunks of 32 KB; 7 slots of a chunk
    # and its mbarrier fit 227 KB. One of them is the store's (the default
    # unload_distance 1), so BATCH's 2d + 1 clamp to 7 and d to 6
    (QWEN3_ROW, 4, IssueStrategy.BATCH, (4, 7, 32768, 56)),
    (QWEN3_ROW, 4, IssueStrategy.SEQUENTIAL, (4, 6, 32768, 56)),
    (QWEN3_ROW, 21, IssueStrategy.BATCH, (6, 7, 32768, 56)),
    (QWEN3_ROW, 64, IssueStrategy.SEQUENTIAL, (5, 7, 32768, 56)),
    # deepseek's planner d* = 28 clamps to 6; a 110,592 B page is three
    # chunks of 32 KB and a last one of 12,288 B
    (DEEPSEEK_ROW, 28, IssueStrategy.BATCH, (6, 7, 32768, 4)),
], ids=["qwen3-d4", "qwen3-d4-seq", "qwen3-d21", "qwen3-d64-seq",
        "deepseek-d28"])
def test_gather_ring_plan_clamps_at_serving_geometries(row_bytes, distance,
                                                       strategy, want):
    plan = gather_bulk_plan(PULConfig(distance=distance, strategy=strategy),
                            rows_per_req=16, row_bytes=row_bytes)
    assert (plan.distance, plan.slots, plan.chunk_bytes, plan.n_chunks) == want
    assert plan.smem_bytes == plan.slots * (plan.chunk_bytes + MBARRIER_BYTES)
    assert plan.smem_bytes <= PA.SMEM_LIMIT_BYTES
    # without the store's slot (a synchronous flush) d reaches the slots
    flush = gather_bulk_plan(PULConfig(distance=distance, strategy=strategy,
                                       unload_distance=0),
                             rows_per_req=16, row_bytes=row_bytes)
    seq = strategy is IssueStrategy.SEQUENTIAL
    assert flush.distance == min(distance, 7 - seq)


def test_gather_ring_plan_small_rows_clamp_to_wait_table():
    plan = gather_bulk_plan(PULConfig(distance=64), rows_per_req=1,
                            row_bytes=1024)
    # 2d preload slots and the store's one
    assert (plan.distance, plan.slots) == (PA.MAX_RING_DISTANCE,
                                           2 * PA.MAX_RING_DISTANCE + 1)
    assert plan.chunk_bytes == 1024 and plan.n_chunks == 1


@pytest.mark.parametrize("row_bytes", [0, 8, 100, 1000])
def test_gather_ring_plan_rejects_rows_off_the_granule(row_bytes):
    with pytest.raises(ValueError, match="16-byte cp.async granules"):
        gather_bulk_plan(PULConfig(), rows_per_req=16, row_bytes=row_bytes)


def test_gather_ring_plan_rejects_a_slab_beyond_shared_memory():
    """A request far beyond shared memory (20,000 rows of 1 KB) is no
    longer refused, as the tile plan did: the bulk plan cuts its span into
    CHUNK_BYTES chunks, and only the chunks pass through the ring."""
    plan = gather_bulk_plan(PULConfig(distance=1), rows_per_req=20000,
                            row_bytes=1024)
    assert plan.chunk_bytes == CHUNK_BYTES
    assert plan.n_chunks == -(-20000 * 1024 // CHUNK_BYTES)
    assert plan.smem_bytes <= PA.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("n_pos,distance,smem_bytes,want", [
    # qwen3 smoke: 512 pages x 56 chunks, one 229,432 B block per SM
    (512 * 56, 4, 229432, 132),
    # deepseek: 512 pages x 4 chunks at d = 6, still every SM
    (512 * 4, 6, 229432, 132),
    # the reference test shape: 40 one-chunk requests at d = 8; 12 blocks
    # would fit an SM, but runs keep two ring depths
    (40, 8, 17 * 1032, 2),
    (3, 8, 17 * 1032, 1),           # fewer positions than a ring depth
])
def test_run_length_fills_the_card_and_the_ring(n_pos, distance, smem_bytes,
                                                want):
    runs = stream_runs(n_pos, distance, smem_bytes, sms=132)
    assert runs == want
    # the kernel's even split: every run is full, and at least 2d long
    # unless the stream is shorter
    assert n_pos // runs >= min(n_pos, 2 * distance)


def test_gather_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on CUDA is refused: only CPU
    tensors take the plain version."""
    table = torch.empty((16, 64), device="meta")
    trace = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pul_gather(table, trace)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pul_page_gather(table.reshape(2, 8, 64), trace.reshape(2, 2))
