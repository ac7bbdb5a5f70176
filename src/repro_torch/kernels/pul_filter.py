"""Filter with bit-vector unloading (K9): the paper's Exp. 5, Fig. 7.

:func:`pul_filter` replaces the reference's ``kernels/pul_filter.py::
pul_filter``: rows stream through the preload ring in blocks of
``rows_per_block``, the predicate ``row[0] > threshold`` is evaluated, and
the result leaves through an unload ring either as a positional bit-vector
(one bit per row, 32 rows per uint32 word, little-endian: the paper's
bandwidth-saving encoding) or as the full rows, zeroed where the predicate
is false (the baseline materialization). ``cfg.unload_distance`` 0 is the
synchronous flush, 1 and up the asynchronous one. The table keeps its own
type (f32, bf16 or f16, as the reference's kernel takes it), and so does the
threshold, rounded to that type first. The kernel is CUDA C++ for Hopper,
``csrc/pul_filter.cu`` (see the note at its head): in bit-vector mode TMA
tiles bring only the start of each row, the DRAM fetch unit that holds
column 0.

Beside it are the plain versions :func:`filter_ref` and
:func:`filter_materialize_ref` (the reference's ``kernels/ref.py``). The
wrapper takes them only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises. ``LAUNCHES["k9"]`` counts its launches.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.pul import CP_ASYNC_BYTES, IssueStrategy, PULConfig
from repro_torch.kernels._runtime import (
    LAUNCHES,
    SMEM_LIMIT_BYTES,
    _blocks_per_sm,
    _check,
    _plan,
    _ptr,
    _raise_on,
    _stream,
    lib,
)
from repro_torch.kernels.pul_gather import split_runs

#: unload ring slots the source's bulk-wait table covers (kMaxUnloadSlots):
#: unload distances above MAX_UNLOAD_SLOTS - 1 run at that distance
MAX_UNLOAD_SLOTS = 8
#: table types the card kernel takes: those the reference's kernel serves
FILTER_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: rows of one TMA box at most (a tensor map's limit on a box side)
MAX_BOX_ROWS = 256
#: bytes of each row a bit-vector tile reads, at most: the card's DRAM
#: fetch (64 B, ``chip_smoke.sector_probe``), which brings the whole unit
#: that holds column 0 whatever the box asks for
TILE_BYTES = 64
#: rows a tensor map can address (its coordinates are 32-bit signed): the
#: limit of the TMA 2D path, rows wider than TILE_BYTES in bit-vector mode
MAX_TABLE_ROWS = 2 ** 31 - 1
#: the bit-vector ring's shared memory when PULConfig.slots is left to the
#: plan: a third of an SM (228 KB) less what the card keeps per block, so
#: that three blocks share an SM (one block, even with d tiles in flight,
#: does not keep up with its SM's share of HBM)
FILTER_SMEM_BYTES = 233472 // 3 - 1024


@dataclasses.dataclass(frozen=True)
class FilterPlan:
    distance: int         # row blocks preloaded ahead of the predicate
    slots: int            # preload ring slots, each one row block
    smem_bytes: int       # dynamic shared memory of one block
    uslots: int           # unload ring slots (0: the lanes store the words)
    unload_distance: int  # flushes in flight behind production (0: sync)
    slot_bytes: int       # bytes of one preload slot (bit-vector: + mbarrier)
    box_rows: int         # rows of one TMA box (bit-vector; 0: materialize)
    tile_bytes: int       # bytes of each row a TMA box reads (bit-vector)
    body: str             # the copies that fill a slot (see filter_ring_plan)


def filter_ring_plan(cfg: PULConfig, *, rows: int, width: int,
                     materialize: bool, itemsize: int = 4,
                     n_rows: int = 0) -> FilterPlan:
    """K9's rings for a table of rows of `width` values of `itemsize` bytes.

    Bit-vector: a preload slot holds the first min(row, TILE_BYTES) bytes
    of each of the block's rows (tile_bytes), filled by TMA boxes of
    box_rows rows (the largest multiple of 32 up to MAX_BOX_ROWS that
    divides rows), plus the slot's 8-byte
    mbarrier: 8,200 B at 128 rows of 64 B. Materialize: a slot holds the
    whole (rows, width) row block. The unload ring holds unload_distance +
    1 results of rows / 8 bytes (bit-vector) or the row block
    (materialize), flushed by bulk copies, which move whole 16-byte units:
    a bit-vector block of a number of rows that is not a multiple of 128
    has no unload ring, and its words are stored by the lanes that hold
    them. The bit-vector ring keeps to FILTER_SMEM_BYTES unless cfg.slots
    is set (d clamps to the slots that fit). body names the copies: TMA 2D
    boxes from a tensor map ("cp.async.bulk.tensor") where the tile is
    narrower than the row, one 1D bulk copy of the block ("cp.async.bulk")
    where it is the row, 16-byte cp.async of whole blocks ("cp.async") for
    materialize. Raises when rows is not a positive multiple of 32, a row is
    not a whole number of 16-byte granules (the tensor map's row stride and
    the copies' unit), the TMA 2D path is to take more rows than a tensor
    map addresses, or one slot does not fit beside the unload ring."""
    if rows < 32 or rows % 32:
        raise ValueError(f"rows_per_block must be a positive multiple of 32 "
                         f"(the bit-packing word), got {rows}")
    row_bytes = width * itemsize
    if row_bytes < CP_ASYNC_BYTES or row_bytes % CP_ASYNC_BYTES:
        raise ValueError(
            f"rows of {width} values of {itemsize} B ({row_bytes} B) are not "
            f"whole {CP_ASYNC_BYTES}-byte granules: the card kernel reads "
            "rows in 16-byte units (a tensor map's row stride is a multiple "
            "of 16 B); the reference takes any width")
    tile = min(TILE_BYTES, row_bytes)
    if not materialize and tile < row_bytes and n_rows > MAX_TABLE_ROWS:
        raise ValueError(f"{n_rows} rows of {row_bytes} B: the tensor map "
                         f"of the TMA 2D tiles addresses at most "
                         f"{MAX_TABLE_ROWS}")
    if materialize:
        slot, box_rows, tile = rows * row_bytes, 0, 0
        out_bytes = slot
    else:
        slot = rows * tile + 8
        box_rows = max(b for b in range(32, MAX_BOX_ROWS + 1, 32)
                       if rows % b == 0)
        out_bytes = rows // 8
    ud = min(cfg.unload_distance, MAX_UNLOAD_SLOTS - 1)
    uslots = ud + 1 if out_bytes % CP_ASYNC_BYTES == 0 else 0
    limit = (FILTER_SMEM_BYTES if not materialize and cfg.slots is None
             else SMEM_LIMIT_BYTES)
    ring = _plan(cfg, uslots * out_bytes, slot,
                 f"a ({rows}, {width}) row block's preload slot", limit)
    body = ("cp.async" if materialize else
            "cp.async.bulk" if tile == row_bytes else "cp.async.bulk.tensor")
    return FilterPlan(ring.distance, ring.slots, ring.smem_bytes, uslots, ud,
                      slot, box_rows, tile, body)


# ---------------------------------------------------------------------- #
# plain versions
# ---------------------------------------------------------------------- #
def _threshold(data: torch.Tensor, threshold) -> torch.Tensor:
    """The threshold in the data's type, as the reference casts it."""
    return torch.as_tensor(threshold, dtype=data.dtype, device=data.device)


def filter_ref(data: torch.Tensor, threshold) -> torch.Tensor:
    """Selection bit-vector (the paper's Exp. 5): bit i set iff
    data[i, 0] > threshold, packed little-endian into uint32 words."""
    bits = (data[:, 0] > _threshold(data, threshold)).to(torch.int64)
    bits = F.pad(bits, (0, (-bits.shape[0]) % 32))
    shifts = torch.arange(32, device=data.device)
    words = (bits.reshape(-1, 32) << shifts).sum(1)        # in [0, 2^32)
    # int64 -> int32 keeps the low 32 bits; viewed as uint32 (few PyTorch
    # kernels take uint32 itself)
    return words.to(torch.int32).view(torch.uint32)


def filter_materialize_ref(data: torch.Tensor, threshold) -> torch.Tensor:
    """Full materialization baseline: selected rows kept, the others zeroed
    (the fixed-shape form of a materialized result set)."""
    keep = data[:, 0] > _threshold(data, threshold)
    return torch.where(keep[:, None], data, 0)


# ---------------------------------------------------------------------- #
# kernel wrapper
# ---------------------------------------------------------------------- #
def pul_filter(data: torch.Tensor, threshold: float, *,
               cfg: PULConfig = PULConfig(), rows_per_block: int = 128,
               materialize: bool = False) -> torch.Tensor:
    """K9: the predicate data[i, 0] > threshold over data (N, W), N a
    multiple of rows_per_block and rows_per_block of 32, the threshold
    rounded to data's type first (as the reference casts it).

    Returns the bit-vector (N / 32,) uint32, or with materialize the rows
    (N, W) in data's type, zeroed where false. CPU tensors take the plain
    versions; CUDA tensors launch the kernel, which takes f32, bf16 and f16
    tables whose rows are whole 16-byte granules on 16-byte boundaries."""
    N, W = data.shape
    rows = rows_per_block
    if rows < 32 or rows % 32 or N % rows:
        raise ValueError(f"{N} rows are not whole blocks of {rows} rows, or "
                         f"{rows} is not a positive multiple of 32")
    if data.device.type == "cpu":
        return (filter_materialize_ref(data, threshold) if materialize
                else filter_ref(data, threshold))
    if data.device.type != "cuda":
        raise ValueError(f"the filter kernel runs on CUDA tensors, got "
                         f"{data.device}")
    if data.dtype not in FILTER_DTYPES:
        raise TypeError(f"data has dtype {data.dtype}, the kernel takes "
                        f"{', '.join(map(str, FILTER_DTYPES))}")
    _check("data", data, (N, W), data.dtype, data.device)
    plan = filter_ring_plan(cfg, rows=rows, width=W, materialize=materialize,
                            itemsize=data.element_size(), n_rows=N)
    if data.data_ptr() % CP_ASYNC_BYTES:
        raise ValueError("the table does not start on a 16-byte boundary "
                         "(whole granules are copied)")
    out = (torch.empty((N, W), dtype=data.dtype, device=data.device)
           if materialize else
           torch.empty((N // 32,), dtype=torch.uint32, device=data.device))
    if N == 0:
        return out
    # the threshold in the table's type, widened exactly to f32 (on the
    # host: no device sync)
    thr = float(_threshold(torch.empty(0, dtype=data.dtype), threshold).float())
    dtype = FILTER_DTYPES.index(data.dtype)
    n_blocks = N // rows
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    run = split_runs(n_blocks, plan.distance,
                     sms * _blocks_per_sm("pul_filter", int(materialize),
                                          dtype, plan.smem_bytes))
    rc = lib("pul_filter").pul_filter(
        _ptr(data), _ptr(out), thr, n_blocks, rows, W * data.element_size(),
        dtype, run, -(-n_blocks // run), plan.distance, plan.slots,
        int(cfg.strategy is IssueStrategy.SEQUENTIAL), plan.uslots,
        plan.unload_distance, int(materialize), plan.box_rows,
        plan.tile_bytes, plan.smem_bytes, _stream(data))
    _raise_on(rc, "pul_filter")
    LAUNCHES["k9"] += 1
    return out
