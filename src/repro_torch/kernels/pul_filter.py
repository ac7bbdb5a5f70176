"""Filter with bit-vector unloading (K9): the paper's Exp. 5, Fig. 7.

:func:`pul_filter` replaces the reference's ``kernels/pul_filter.py::
pul_filter``: rows stream through the preload ring in blocks of
``rows_per_block``, the predicate ``row[0] > threshold`` is evaluated, and
the result leaves through an unload ring either as a positional bit-vector
(one bit per row, 32 rows per uint32 word, little-endian: the paper's
bandwidth-saving encoding) or as the full rows, zeroed where the predicate
is false (the baseline materialization). ``cfg.unload_distance`` 0 is the
synchronous flush, 1 and up the asynchronous one. The kernel is CUDA C++
for Hopper, ``csrc/pul_filter.cu`` (see the note at its head).

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


@dataclasses.dataclass(frozen=True)
class FilterPlan:
    distance: int         # row blocks preloaded ahead of the predicate
    slots: int            # preload ring slots, each one row block
    smem_bytes: int       # dynamic shared memory of one block
    uslots: int           # unload ring slots (0: the lanes store the words)
    unload_distance: int  # flushes in flight behind production (0: sync)


def filter_ring_plan(cfg: PULConfig, *, rows: int, width: int,
                     materialize: bool) -> FilterPlan:
    """K9's rings: a preload slot holds one (rows, width) f32 row block; the
    unload ring holds unload_distance + 1 results of rows / 8 bytes
    (bit-vector) or rows * width * 4 (materialize), flushed by bulk copies,
    which move whole 16-byte units: a bit-vector block of a number of rows
    that is not a multiple of 128 has no unload ring, and its words are
    stored by the lanes that hold them. Raises when rows is not a positive
    multiple of 32 or one row block does not fit beside the unload ring."""
    if rows < 32 or rows % 32:
        raise ValueError(f"rows_per_block must be a positive multiple of 32 "
                         f"(the bit-packing word), got {rows}")
    in_bytes = rows * width * 4
    out_bytes = in_bytes if materialize else rows // 8
    ud = min(cfg.unload_distance, MAX_UNLOAD_SLOTS - 1)
    uslots = ud + 1 if out_bytes % CP_ASYNC_BYTES == 0 else 0
    ring = _plan(cfg, uslots * out_bytes, in_bytes,
                 f"a ({rows}, {width}) f32 row block")
    return FilterPlan(ring.distance, ring.slots, ring.smem_bytes, uslots, ud)


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
    multiple of rows_per_block and rows_per_block of 32.

    Returns the bit-vector (N / 32,) uint32, or with materialize the rows
    (N, W) zeroed where false. CPU tensors take the plain versions; CUDA
    tensors launch the kernel, which takes f32 rows of whole 16-byte
    granules."""
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
    _check("data", data, (N, W), torch.float32, data.device)
    if W % 4 or data.data_ptr() % CP_ASYNC_BYTES:
        raise ValueError(f"rows of {W} f32 values are not whole 16-byte "
                         "granules on 16-byte boundaries")
    plan = filter_ring_plan(cfg, rows=rows, width=W, materialize=materialize)
    out = (torch.empty((N, W), dtype=torch.float32, device=data.device)
           if materialize else
           torch.empty((N // 32,), dtype=torch.uint32, device=data.device))
    if N == 0:
        return out
    n_blocks = N // rows
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    run = split_runs(n_blocks, plan.distance,
                     sms * _blocks_per_sm("pul_filter", int(materialize),
                                          plan.smem_bytes))
    rc = lib("pul_filter").pul_filter(
        _ptr(data), _ptr(out), float(threshold), n_blocks, rows, W, run,
        -(-n_blocks // run), plan.distance, plan.slots,
        int(cfg.strategy is IssueStrategy.SEQUENTIAL), plan.uslots,
        plan.unload_distance, int(materialize), plan.smem_bytes,
        _stream(data))
    _raise_on(rc, "pul_filter")
    LAUNCHES["k9"] += 1
    return out
