"""The port's microbenchmark slice (K8 SUM, K9 filter, K10 matmul, the
paper's experiments and examples) against the reference.

On the CPU each wrapper takes its plain version; the same numpy inputs go
through the reference's Pallas kernels in interpret mode, at the shapes and
tolerances of tests/test_kernels.py (the filter bitwise). The CUDA kernels
run only on the card (tests/test_torch_cuda.py); their ring plans and run
splits are plain Python and are checked here at the smoke's shapes. The
port's Exps. 1-5 give the reference's rows line for line.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IssueStrategy as RefIssueStrategy
from repro.core import PULConfig as RefPULConfig
from repro.kernels.pul_filter import pul_filter as ref_filter
from repro.kernels.pul_matmul import pul_matmul as ref_matmul
from repro.kernels.pul_sum import pul_sum as ref_sum
from repro_torch.benchmarks import paper_experiments as P
from repro_torch.core import IssueStrategy, PULConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pul_attention import (
    LAUNCHES,
    SMEM_LIMIT_BYTES,
    attention_kernel_ref,
)
from repro_torch.kernels.pul_filter import filter_ring_plan, pul_filter
from repro_torch.kernels.pul_matmul import (
    FMA_CHUNK,
    TC_BM,
    TC_BN,
    matmul_body,
    matmul_ring_plan,
    matmul_tc_plan,
    pul_matmul,
)
from repro_torch.kernels.pul_gather import split_runs
from repro_torch.kernels.pul_sum import pul_sum, sum_ring_plan

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:            # the reference's benchmarks package
    sys.path.insert(0, str(ROOT))

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
STRATEGIES = {"batch": (RefIssueStrategy.BATCH, IssueStrategy.BATCH),
              "seq": (RefIssueStrategy.SEQUENTIAL, IssueStrategy.SEQUENTIAL)}


def _pair(x: np.ndarray, dtype: str):
    """One numpy array as a reference (jax) and a port (torch) array of
    `dtype`: both round f32 to bf16 to nearest even."""
    jt, tt = DTYPES[dtype]
    return jnp.asarray(x).astype(jt), torch.from_numpy(x).to(tt)


def _cfgs(distance, strategy="batch", **kw):
    rs, ps = STRATEGIES[strategy]
    return (RefPULConfig(distance=distance, strategy=rs, **kw),
            PULConfig(distance=distance, strategy=ps, **kw))


# ------------------------------------------------------------------ K8 sum
@pytest.mark.parametrize("rows_per_req", [1, 4])
@pytest.mark.parametrize("distance,strategy", [
    (1, "batch"), (4, "batch"), (3, "seq"), (16, "batch")])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sum_plain_matches_reference_kernel(dtype, distance, strategy,
                                            rows_per_req):
    R, W, n = 32, 128, 18
    rng = np.random.default_rng(0)
    jd, td = _pair(rng.standard_normal((R * rows_per_req, W),
                                       dtype=np.float32), dtype)
    trace = rng.integers(0, R, size=n).astype(np.int32)
    rcfg, pcfg = _cfgs(distance, strategy)
    want = ref_sum(jd, jnp.asarray(trace), cfg=rcfg,
                   rows_per_req=rows_per_req)
    got = pul_sum(td, torch.from_numpy(trace), cfg=pcfg,
                  rows_per_req=rows_per_req)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want),
                               rtol=3e-2 if dtype == "bf16" else 1e-5)


# --------------------------------------------------------------- K9 filter
def _filter_pair(N, W, rows, materialize, rcfg, pcfg, threshold=0.25):
    x = np.random.default_rng(1).standard_normal((N, W), dtype=np.float32)
    want = np.asarray(ref_filter(jnp.asarray(x), threshold, cfg=rcfg,
                                 rows_per_block=rows,
                                 materialize=materialize))
    got = pul_filter(torch.from_numpy(x), threshold, cfg=pcfg,
                     rows_per_block=rows, materialize=materialize)
    assert got.dtype == (torch.float32 if materialize else torch.uint32)
    np.testing.assert_array_equal(got.numpy(), want)   # bitwise, same dtype
    assert got.numpy().dtype == want.dtype


@pytest.mark.parametrize("distance", [2, 8])
@pytest.mark.parametrize("materialize", [False, True])
def test_filter_plain_matches_reference_kernel(materialize, distance):
    _filter_pair(512, 64, 128, materialize, *_cfgs(distance))


@pytest.mark.parametrize("unload_distance", [0, 1])
@pytest.mark.parametrize("materialize", [False, True])
def test_filter_plain_matches_reference_kernel_64_row_blocks(
        materialize, unload_distance):
    """The paper's Exp. 5 block of 64 rows (8 bytes of bit-vector, below the
    16-byte bulk copy), with the synchronous and the asynchronous flush."""
    _filter_pair(256, 32, 64, materialize,
                 *_cfgs(4, unload_distance=unload_distance), threshold=0.0)


@pytest.mark.parametrize("unload_distance", [0, 1])
@pytest.mark.parametrize("materialize", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_filter_plain_matches_reference_kernel_in_the_table_type(
        dtype, materialize, unload_distance):
    """bf16 and f16 tables: the reference's kernel compares in the table's
    type, the threshold 0.3 rounded to it; column 0 planted at that rounded
    value and one ulp either side. Bitwise, in the table's type."""
    jt, tt = {"bf16": (jnp.bfloat16, torch.bfloat16),
              "f16": (jnp.float16, torch.float16)}[dtype]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((512, 64), dtype=np.float32)
                         * 0.5).to(tt)
    thr = torch.tensor(0.3, dtype=tt)
    x[::7, 0] = thr
    x[3::11, 0] = torch.nextafter(thr, torch.tensor(1.0, dtype=tt))
    x[5::13, 0] = torch.nextafter(thr, torch.tensor(0.0, dtype=tt))
    rcfg, pcfg = _cfgs(4, unload_distance=unload_distance)
    want = np.asarray(ref_filter(jnp.asarray(x.float().numpy()).astype(jt),
                                 0.3, cfg=rcfg, rows_per_block=128,
                                 materialize=materialize))
    got = pul_filter(x, 0.3, cfg=pcfg, rows_per_block=128,
                     materialize=materialize)
    assert got.dtype == (tt if materialize else torch.uint32)
    if materialize:
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    kept = x[:, 0] > thr
    ties = x[:, 0] == thr
    assert 0 < int(kept.sum()) < 512 and bool(ties.any())
    assert not bool(kept[ties].any())


def test_filter_bit_order_is_little_endian():
    x = np.zeros((64, 4), np.float32)
    x[[0, 3, 31, 32, 63], 0] = 1.0
    words = ref.filter_ref(torch.from_numpy(x), 0.5)
    assert words.view(torch.int32).tolist() == [
        (1 << 0) | (1 << 3) | (-(1 << 31)), (1 << 0) | (-(1 << 31))]


# --------------------------------------------------------------- K10 matmul
@pytest.mark.parametrize("distance", [1, 3])
@pytest.mark.parametrize("shape,blocks", [
    ((128, 128, 128), (64, 64, 64)),
    ((128, 256, 384), (64, 128, 128)),
    ((64, 512, 128), (64, 64, 128)),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_plain_matches_reference_kernel(dtype, shape, blocks,
                                               distance):
    M, K, N = shape
    bm, bk, bn = blocks
    rng = np.random.default_rng(2)
    ja, ta = _pair(rng.standard_normal((M, K), dtype=np.float32), dtype)
    jb, tb = _pair(rng.standard_normal((K, N), dtype=np.float32), dtype)
    rcfg, pcfg = _cfgs(distance)
    want = np.asarray(ref_matmul(ja, jb, cfg=rcfg, bm=bm, bk=bk, bn=bn))
    got = pul_matmul(ta, tb, cfg=pcfg, bm=bm, bk=bk, bn=bn)
    assert got.dtype == torch.float32
    rtol = 2e-2 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * 10)


def test_matmul_out_dtype_is_the_cast_of_the_fp32_product():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 128), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 64), dtype=np.float32))
    got = pul_matmul(a, b, bm=64, bk=64, bn=64, out_dtype=torch.bfloat16)
    assert torch.equal(got, (a @ b).to(torch.bfloat16))
    with pytest.raises(ValueError, match="tiles"):
        pul_matmul(a, b, bm=48, bk=64, bn=64)


# ------------------------------------------------ ring plans and run splits
SWEEP = [(d, s) for d in (1, 2, 4, 8, 16, 32) for s in IssueStrategy]


@pytest.mark.parametrize("rows_per_req", [1, 16, 128])
def test_sum_plan_at_the_smoke_shapes(rows_per_req):
    """The smoke's table: 64-byte rows, requests of 1, 16 and 128 rows."""
    req = 64 * rows_per_req
    granules = req // 16
    for d, strategy in SWEEP:
        plan = sum_ring_plan(PULConfig(distance=d, strategy=strategy),
                             req_bytes=req)
        assert plan.lanes == min(32, granules) and 32 % plan.lanes == 0
        assert plan.lanes * plan.per_lane * 16 >= req
        assert plan.smem_bytes == plan.slots * 128 * plan.per_lane * 16
        assert plan.smem_bytes <= SMEM_LIMIT_BYTES
        seq = strategy is IssueStrategy.SEQUENTIAL
        assert plan.slots >= plan.distance + (1 if seq else 0)
        if rows_per_req == 1:           # 2 KB per position: nothing clamps
            assert plan.distance == d
            assert plan.slots == (d + 1 if seq else 2 * d)
    assert sum_ring_plan(PULConfig(distance=16),
                         req_bytes=8192).distance == 7
    with pytest.raises(ValueError, match="granules"):
        sum_ring_plan(PULConfig(), req_bytes=40)
    with pytest.raises(ValueError, match="does not fit"):   # 4 x 64 KB
        sum_ring_plan(PULConfig(), req_bytes=65536)


@pytest.mark.parametrize("n,distance,pes", [
    (2 ** 24, 4, 132 * 13 * 32),        # the smoke's SUM at d = 4
    (2 ** 24 // 128, 7, 132 * 1 * 4),   # 8 KB requests: one block per SM
    (2 ** 19, 4, 132 * 2),              # the smoke's filter row blocks
    (18, 16, 10 ** 6), (1, 1, 1), (1000, 3, 7)])
def test_split_runs_cover_the_stream(n, distance, pes):
    run = split_runs(n, distance, pes)
    n_runs = -(-n // run)
    assert n_runs <= pes and (n_runs - 1) * run < n <= n_runs * run
    assert run >= min(n, 2 * distance)


def test_filter_plan_at_the_smoke_shapes():
    """Bit-vector slots hold the first 64 bytes of each row, the DRAM fetch
    unit that holds column 0 (the whole 64-byte row here, 8 KB at 128 rows),
    and their mbarrier; materialize slots the whole row block; 64-row
    blocks' 8 bytes of words leave by lane stores."""
    for ud in (0, 1):
        bv = filter_ring_plan(PULConfig(unload_distance=ud), rows=128,
                              width=16, materialize=False)
        assert (bv.uslots, bv.unload_distance) == (ud + 1, ud)
        assert (bv.slot_bytes, bv.box_rows, bv.tile_bytes) == (
            128 * 64 + 8, 128, 64)
        assert bv.smem_bytes == bv.slots * 8200 + bv.uslots * 16
        mat = filter_ring_plan(PULConfig(unload_distance=ud), rows=128,
                               width=16, materialize=True)
        assert mat.smem_bytes == mat.slots * 8192 + (ud + 1) * 8192
        assert (mat.slot_bytes, mat.box_rows, mat.tile_bytes) == (8192, 0, 0)
        # 64-row blocks: 8 bytes of words, below the 16-byte bulk copy
        small = filter_ring_plan(PULConfig(unload_distance=ud), rows=64,
                                 width=32, materialize=False)
        assert small.uslots == 0 and small.smem_bytes == small.slots * 4104
    for d, strategy in SWEEP:
        plan = filter_ring_plan(PULConfig(distance=d, strategy=strategy),
                                rows=128, width=16, materialize=True)
        assert plan.smem_bytes <= SMEM_LIMIT_BYTES and plan.distance >= 1
        bv = filter_ring_plan(PULConfig(distance=d, strategy=strategy),
                              rows=128, width=4, materialize=False)
        assert bv.distance == d        # 2 KB slots: nothing clamps
        assert bv.smem_bytes <= SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="multiple of 32"):
        filter_ring_plan(PULConfig(), rows=48, width=16, materialize=False)


@pytest.mark.parametrize("rows,box_rows", [(32, 32), (64, 64), (96, 96),
                                           (128, 128), (256, 256),
                                           (384, 192), (512, 256),
                                           (1024, 256)])
def test_filter_plan_cuts_blocks_into_tma_boxes(rows, box_rows):
    """A TMA box spans at most 256 rows: a row block is loaded as whole
    boxes, the largest multiple of 32 that divides it."""
    plan = filter_ring_plan(PULConfig(), rows=rows, width=16,
                            materialize=False)
    assert plan.box_rows == box_rows and rows % plan.box_rows == 0
    assert plan.slot_bytes == rows * 64 + 8


@pytest.mark.parametrize("width,itemsize", [(6, 4), (4, 2), (12, 2), (2, 4),
                                            (7, 2)])
def test_filter_plan_refuses_rows_of_partial_granules(width, itemsize):
    """A tensor map's row stride and the copies move 16-byte units: rows of
    24, 8, 24, 8 or 14 bytes raise, naming the granule."""
    for materialize in (False, True):
        with pytest.raises(ValueError, match="granules"):
            filter_ring_plan(PULConfig(), rows=128, width=width,
                             materialize=materialize, itemsize=itemsize)


def test_filter_plan_takes_every_card_type_and_refuses_huge_tables():
    """The tile is the first 64 bytes of a row, or the row when shorter.
    Only the TMA 2D path (rows wider than the tile) has a tensor map, and
    only it refuses a table of 2^31 rows or more."""
    for width, itemsize, tile in ((16, 4, 64), (32, 2, 64), (16, 2, 32),
                                  (8, 2, 16), (4, 4, 16), (64, 4, 64),
                                  (20, 4, 64), (48, 2, 64)):
        plan = filter_ring_plan(PULConfig(), rows=128, width=width,
                                materialize=False, itemsize=itemsize,
                                n_rows=2 ** 26)
        assert plan.tile_bytes == tile
        assert plan.slot_bytes == 128 * tile + 8
        # the whole row: one bulk copy of the block; part of it: TMA boxes
        assert plan.body == ("cp.async.bulk" if tile == width * itemsize
                             else "cp.async.bulk.tensor")
    assert filter_ring_plan(PULConfig(), rows=128, width=16,
                            materialize=True).body == "cp.async"
    with pytest.raises(ValueError, match="tensor map"):
        filter_ring_plan(PULConfig(), rows=128, width=32, materialize=False,
                         n_rows=2 ** 31)
    # a 64-byte row is one bulk copy, materialize copies granules: neither
    # addresses rows through a tensor map
    huge = [filter_ring_plan(PULConfig(), rows=128, width=16,
                             materialize=m, n_rows=2 ** 31) for m in (0, 1)]
    assert [p.body for p in huge] == ["cp.async.bulk", "cp.async"]


@pytest.mark.parametrize("itemsize", [4, 2])
def test_matmul_default_tile_plan(itemsize):
    """matmul_op's default (128, 128, 128) tiles: the ring streams its own
    chunk of K, so both issue orders run at the default distance."""
    for strategy in IssueStrategy:
        cfg = PULConfig(strategy=strategy)
        plan = matmul_ring_plan(cfg, bm=128, bk=128, bn=128,
                                itemsize=itemsize)
        assert plan.distance == cfg.distance >= 2
        assert 128 % plan.bk_chunk == 0
        assert (plan.bk_chunk * itemsize) % 16 == 0
        # A transposed, its rows of 128 words padded by one 16-byte granule
        slot = (256 + 4) * plan.bk_chunk * itemsize
        assert plan.smem_bytes == plan.slots * slot
        assert plan.smem_bytes <= SMEM_LIMIT_BYTES
        assert plan.slots >= cfg.distance + (
            1 if strategy is IssueStrategy.SEQUENTIAL else 0)
    assert matmul_ring_plan(PULConfig(), bm=128, bk=128, bn=128,
                            itemsize=4).bk_chunk == 16
    # the chunk is the body's compile-time K depth at every tile
    assert matmul_ring_plan(PULConfig(distance=3), bm=64, bk=64, bn=64,
                            itemsize=4).bk_chunk == FMA_CHUNK


@pytest.mark.parametrize("strategy", list(IssueStrategy),
                         ids=lambda s: s.name.lower())
@pytest.mark.parametrize("distance", [1, 2, 4, 8])
@pytest.mark.parametrize("bm,bn", [(bm, bn) for bm in TC_BM for bn in TC_BN])
def test_matmul_tc_plan_fits_shared_memory(bm, bn, distance, strategy):
    """The tensor-core body's ring at every tile it takes, for K tiles of
    16 to 256: the K chunk is one swizzled row (64 bf16) where bk allows,
    each slot holds the A and B tiles and two mbarriers, and distance and
    slots follow PULConfig within 227 KB."""
    cfg = PULConfig(distance=distance, strategy=strategy)
    seq = strategy is IssueStrategy.SEQUENTIAL
    for bk, chunk in ((16, 16), (32, 32), (64, 64), (96, 32), (128, 64),
                      (256, 64)):
        plan = matmul_tc_plan(cfg, bm=bm, bk=bk, bn=bn)
        slot = (bm + bn) * chunk * 2 + 16
        assert plan.bk_chunk == chunk
        assert plan.smem_bytes == plan.slots * slot + 1024
        assert plan.smem_bytes <= SMEM_LIMIT_BYTES
        assert plan.slots >= plan.distance + seq
        assert 1 <= plan.distance <= distance
        want_slots = distance + 1 if seq else 2 * distance
        fits = (SMEM_LIMIT_BYTES - 1024) // slot
        assert plan.slots == min(want_slots, fits)
        if want_slots <= fits:
            assert plan.distance == distance
    with pytest.raises(ValueError, match="chunks of 16"):
        matmul_tc_plan(cfg, bm=bm, bk=8, bn=bn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bm", [32, 64, 128])
@pytest.mark.parametrize("bn", [32, 64, 128])
def test_matmul_body_follows_dtype_and_tiles(dtype, bm, bn):
    """bf16 with bm >= 64 runs on the tensor cores (wgmma), everything else
    (f32, bm = 32) on the CUDA cores (the register-tiled fma body)."""
    want = "wgmma" if dtype == torch.bfloat16 and bm >= 64 else "fma-tiled"
    assert matmul_body(dtype, bm, bn) == want


# ------------------------------------------------------ wrappers, ops, ref
def test_ops_route_to_the_kernels_and_plain_versions_on_cpu():
    rng = np.random.default_rng(4)
    data = torch.from_numpy(rng.standard_normal((256, 32), dtype=np.float32))
    trace = torch.from_numpy(rng.integers(0, 128, size=20, dtype=np.int32))
    before = dict(LAUNCHES)
    assert torch.equal(ops.sum_op(data, trace, rows_per_req=2),
                       pul_sum(data, trace, rows_per_req=2))
    assert torch.equal(ops.gather_op(data, trace), ref.gather_ref(data, trace))
    assert torch.equal(ops.filter_op(data, 0.1).view(torch.int32),
                       ref.filter_ref(data, 0.1).view(torch.int32))
    assert torch.equal(ops.filter_op(data, 0.1, materialize=True),
                       ref.filter_materialize_ref(data, 0.1))
    a = torch.from_numpy(rng.standard_normal((128, 128), dtype=np.float32))
    assert torch.equal(ops.matmul_op(a, a.T.contiguous()),
                       ref.matmul_ref(a, a.T))
    q = torch.from_numpy(rng.standard_normal((1, 2, 32, 16), dtype=np.float32))
    assert torch.equal(ops.attention_op(q, q, q, bt=32, bs=16),
                       attention_kernel_ref(q, q, q, bs=16))
    assert dict(LAUNCHES) == before     # the plain versions count nothing


def test_wrappers_refuse_other_devices_instead_of_falling_back():
    meta = torch.empty((64, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pul_sum(meta, torch.zeros(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        pul_filter(meta, 0.0, rows_per_block=32)
    with pytest.raises(ValueError, match="CUDA"):
        pul_matmul(meta, torch.empty((16, 64), device="meta"), bm=64, bk=16,
                   bn=64)


# ----------------------------------------------------- the slice as a whole
@pytest.mark.parametrize("exp", ["exp1_roofline",
                                 "exp2_intensity_constant_time",
                                 "exp3_distance", "exp4_transfer_size",
                                 "exp5_unload"])
def test_experiment_rows_equal_the_reference(exp):
    from benchmarks import paper_experiments as R
    for mod in (R, P):
        mod.ROWS.clear()
        mod.CLAIMS.clear()
    getattr(R, exp)()
    getattr(P, exp)()
    assert P.ROWS == R.ROWS and P.CLAIMS == R.CLAIMS
    assert len(P.ROWS) > 0


def test_run_all_on_cpu_passes_every_claim():
    rows, claims = P.run_all(device="cpu")
    assert len(claims) == 11
    assert all(": PASS (" in c for c in claims), claims
    assert "kernels/functional_sweep,pass," in rows


def _run(module):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", module, "--device", "cpu"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_benchmark_cli_on_cpu():
    proc = _run("repro_torch.benchmarks.run")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count(": PASS (") == 11
    assert "11 claims (0 failed)" in proc.stdout
    assert "not ported yet" in proc.stdout


@pytest.mark.parametrize("example,says", [
    ("quickstart", "random rows) = 4.359 on cpu; plain sum 4.359; within"),
    ("pul_microbench", "validated through the PUL gather on cpu")])
def test_examples_run_on_cpu(example, says):
    proc = _run(f"repro_torch.examples.{example}")
    assert proc.returncode == 0, proc.stderr
    assert says in proc.stdout
