"""PUL random row gather (K5) of the serving assembly path.

:func:`pul_gather` replaces the reference's ``kernels/pul_gather.py::
pul_gather``: ``out[i*r:(i+1)*r] = table[trace[i]*r : +r]`` through a
preload ring. :func:`pul_page_gather` is its page form, the engine's
assembly gather: a paged store ``(n_pages, P, F)`` gathered by page table
into ``(n_seqs, pages_per_seq * P, F)``. The kernel is CUDA C++ for Hopper,
``csrc/pul_gather.cu`` (see the note at its head).

Beside it are the plain versions :func:`gather_ref` (``table[trace]``, the
reference's ``kernels/ref.py::gather_ref``) and :func:`page_gather_ref`. A
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``LAUNCHES["k5"]`` counts its
launches. :func:`gather_ring_plan` budgets the ring against shared memory.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.pul import CP_ASYNC_BYTES, IssueStrategy, PULConfig
from repro_torch.kernels._runtime import (
    LAUNCHES,
    _check,
    _plan,
    _ptr,
    _raise_on,
    _stream,
    lib,
)

#: bytes of one ring slot the tile width aims at: a (rows_per_req, tile)
#: slab; 14 such slots fit the 227 KB a block may use
SLOT_TARGET_BYTES = 16384
#: blocks per SM the host aims the grid at (run lengths shrink until then,
#: but never below two ring depths of requests)
BLOCKS_PER_SM = 4
#: element types the wrapper takes (the reference's tests: f32, bf16, int32)
DTYPES = (torch.float32, torch.bfloat16, torch.int32)


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    distance: int       # requests preloaded ahead of the copy-out
    slots: int          # ring slots, each one (rows_per_req, tile) slab
    smem_bytes: int     # dynamic shared memory of one block
    tile_bytes: int     # bytes of each row one block copies
    n_tiles: int        # tiles across a row (the last may be narrower)


def gather_ring_plan(cfg: PULConfig, *, rows_per_req: int,
                     row_bytes: int) -> GatherPlan:
    """K5's ring: rows are cut into tiles so that a slot of rows_per_req
    tile rows is about SLOT_TARGET_BYTES; distance and slots are clamped to
    shared memory and to the 32-entry wait table as for K1-K4. Raises for a
    row that is not whole 16-byte cp.async granules."""
    if row_bytes < CP_ASYNC_BYTES or row_bytes % CP_ASYNC_BYTES:
        raise ValueError(
            f"a row of {row_bytes} B is not a whole number of "
            f"{CP_ASYNC_BYTES}-byte cp.async granules")
    tile = SLOT_TARGET_BYTES // rows_per_req // CP_ASYNC_BYTES * CP_ASYNC_BYTES
    tile = min(row_bytes, max(CP_ASYNC_BYTES, tile))
    ring = _plan(cfg, 0, rows_per_req * tile,
                 f"a ({rows_per_req}, {tile} B) request slab")
    return GatherPlan(ring.distance, ring.slots, ring.smem_bytes, tile,
                      -(-row_bytes // tile))


def split_runs(n: int, distance: int, pes: int) -> int:
    """Length of the runs of consecutive stream positions (requests, row
    blocks) that the PEs walk: at most `pes` runs, and each run at least two
    ring depths long (or all n) so that its ring runs full."""
    n_runs = max(1, min(pes, -(-n // (2 * distance))))
    return -(-n // n_runs)


def run_length(n_req: int, n_tiles: int, distance: int, sms: int) -> int:
    """Requests one block walks: few enough that the grid of (runs, tiles)
    reaches BLOCKS_PER_SM blocks per SM, and at least two ring depths (or
    every request) so the ring runs full."""
    return split_runs(n_req, distance, -(-BLOCKS_PER_SM * sms // n_tiles))


# ---------------------------------------------------------------------- #
# plain versions
# ---------------------------------------------------------------------- #
def gather_ref(table: torch.Tensor, trace: torch.Tensor) -> torch.Tensor:
    """Random row gather: out[i] = table[trace[i]]."""
    return table[trace.long()]


def page_gather_ref(store: torch.Tensor, page_table: torch.Tensor
                    ) -> torch.Tensor:
    """store (n_pages, P, F) gathered by page_table (n_seqs, pages) into
    (n_seqs, pages * P, F)."""
    n_seqs, pages = page_table.shape
    return gather_ref(store, page_table).reshape(
        n_seqs, pages * store.shape[1], store.shape[2])


# ---------------------------------------------------------------------- #
# kernel wrapper
# ---------------------------------------------------------------------- #
def pul_gather(table: torch.Tensor, trace: torch.Tensor, *,
               cfg: PULConfig = PULConfig(),
               rows_per_req: int = 1) -> torch.Tensor:
    """K5: out[i*r:(i+1)*r] = table[trace[i]*r : +r], r = rows_per_req.

    table (R, W) f32 / bf16 / int32 with R a multiple of r; trace (n,)
    int32. Returns (n * r, W). CPU tensors take the plain version; CUDA
    tensors launch the kernel, which needs rows of whole 16-byte granules."""
    R, W = table.shape
    if rows_per_req < 1 or R % rows_per_req:
        raise ValueError(f"{R} table rows are not whole requests of "
                         f"{rows_per_req} rows")
    n = trace.shape[0]
    if table.device.type == "cpu":
        return gather_ref(table.reshape(R // rows_per_req, rows_per_req * W),
                          trace).reshape(n * rows_per_req, W)
    if table.device.type != "cuda":
        raise ValueError(f"the gather kernel runs on CUDA tensors, got "
                         f"{table.device}")
    if table.dtype not in DTYPES:
        raise TypeError(f"table has dtype {table.dtype}, the kernel takes "
                        f"{', '.join(map(str, DTYPES))}")
    _check("table", table, (R, W), table.dtype, table.device)
    _check("trace", trace, (n,), torch.int32, table.device)
    if table.data_ptr() % CP_ASYNC_BYTES:
        raise ValueError("table rows must start on 16-byte boundaries")
    row_bytes = W * table.element_size()
    plan = gather_ring_plan(cfg, rows_per_req=rows_per_req,
                            row_bytes=row_bytes)
    out = torch.empty((n * rows_per_req, W), dtype=table.dtype,
                      device=table.device)
    if n == 0:
        return out
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    rc = lib("pul_gather").pul_gather(
        _ptr(table), _ptr(trace), _ptr(out), n, rows_per_req, row_bytes,
        plan.tile_bytes, run_length(n, plan.n_tiles, plan.distance, sms),
        plan.distance, plan.slots,
        int(cfg.strategy is IssueStrategy.SEQUENTIAL), plan.smem_bytes,
        _stream(table))
    _raise_on(rc, "pul_gather")
    LAUNCHES["k5"] += 1
    return out


def pul_page_gather(store: torch.Tensor, page_table: torch.Tensor, *,
                    cfg: PULConfig = PULConfig()) -> torch.Tensor:
    """Assemble sequences from a paged store (the serving gather path).

    store (n_pages, P, F); page_table (n_seqs, pages_per_seq) int32 page
    ids. Returns (n_seqs, pages_per_seq * P, F): each sequence's pages in
    page-table order, through :func:`pul_gather` with P rows per request."""
    n_pages, P, F = store.shape
    n_seqs, pages = page_table.shape
    flat = pul_gather(store.reshape(n_pages * P, F), page_table.reshape(-1),
                      cfg=cfg, rows_per_req=P)
    return flat.reshape(n_seqs, pages * P, F)
