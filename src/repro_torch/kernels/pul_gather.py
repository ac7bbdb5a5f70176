"""PUL random row gather (K5) of the serving assembly path.

:func:`pul_gather` replaces the reference's ``kernels/pul_gather.py::
pul_gather``: ``out[i*r:(i+1)*r] = table[trace[i]*r : +r]`` through a
preload ring and an unload ring. :func:`pul_page_gather` is its page form,
the engine's assembly gather: a paged store ``(n_pages, P, F)`` gathered by
page table into ``(n_seqs, pages_per_seq * P, F)``. The kernel is CUDA C++
for Hopper, ``csrc/pul_gather.cu`` (see the note at its head): each
request's span is cut into chunks that 1D bulk copies (TMA) move into and
out of a shared-memory ring.

Beside it are the plain versions :func:`gather_ref` (``table[trace]``, the
reference's ``kernels/ref.py::gather_ref``) and :func:`page_gather_ref`. A
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``LAUNCHES["k5"]`` counts its
launches. :func:`gather_bulk_plan` cuts the spans into chunks and budgets
the ring against shared memory; :func:`stream_runs` cuts the stream into
one run per block.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.pul import CP_ASYNC_BYTES, IssueStrategy, PULConfig
from repro_torch.kernels._runtime import (
    LAUNCHES,
    MAX_RING_DISTANCE,
    SMEM_LIMIT_BYTES,
    _check,
    _ptr,
    _raise_on,
    _stream,
    lib,
)

#: bytes of one chunk, the unit of a bulk copy and of a ring slot: a span
#: longer than this is cut into CHUNK_BYTES chunks and a narrower last one
CHUNK_BYTES = 32768
#: shared memory of one SM (228 KB); each resident block also takes 1 KB
SMEM_PER_SM_BYTES = 233472
#: bytes of the mbarrier each ring slot carries
MBARRIER_BYTES = 8
#: element types the wrapper takes (the reference's tests: f32, bf16, int32)
DTYPES = (torch.float32, torch.bfloat16, torch.int32)
#: the body that runs on the card (the ``body`` field of the smoke's rows)
BODY = "cp.async.bulk"


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    distance: int       # positions preloaded ahead of the store
    slots: int          # ring slots, each one chunk and its mbarrier
    smem_bytes: int     # dynamic shared memory of one block
    chunk_bytes: int    # bytes of a chunk (the last of a span may be fewer)
    n_chunks: int       # chunks of one request's span


def gather_bulk_plan(cfg: PULConfig, *, rows_per_req: int,
                     row_bytes: int) -> GatherPlan:
    """K5's stream and ring: a request's span of rows_per_req * row_bytes
    is cut into chunks of CHUNK_BYTES (or one chunk of the whole span), and
    each slot holds a chunk and its mbarrier. A slot is loaded from global
    memory and stored back from itself, so besides the preload ring's
    slots (PULConfig's, 2d BATCH, d + 1 SEQUENTIAL) the ring keeps
    cfg.unload_distance slots for stores still reading theirs: a reload
    waits only for the store that many positions back (0: for every store
    issued, the synchronous flush). Distance and slots are clamped to
    shared memory and to the 32-entry wait table. Raises for a row that is
    not whole 16-byte granules."""
    if row_bytes < CP_ASYNC_BYTES or row_bytes % CP_ASYNC_BYTES:
        raise ValueError(
            f"a row of {row_bytes} B is not a whole number of "
            f"{CP_ASYNC_BYTES}-byte cp.async granules")
    span = rows_per_req * row_bytes
    chunk = min(span, CHUNK_BYTES)
    slot = chunk + MBARRIER_BYTES
    seq = int(cfg.strategy is IssueStrategy.SEQUENTIAL)
    lag = cfg.unload_distance
    max_slots = SMEM_LIMIT_BYTES // slot
    d = min(cfg.distance, MAX_RING_DISTANCE, max_slots - seq - lag)
    if d < 1:
        raise ValueError(f"a {chunk} B chunk leaves no ring in the "
                         f"{SMEM_LIMIT_BYTES} B of shared memory")
    want = cfg.slots if cfg.slots is not None else (d + 1 if seq else 2 * d)
    slots = min(max(want, d + seq) + lag, max_slots)
    return GatherPlan(d, slots, slots * slot, chunk, -(-span // chunk))


def split_runs(n: int, distance: int, pes: int) -> int:
    """Length of the runs of consecutive stream positions (requests, row
    blocks) that the PEs walk: at most `pes` runs, and each run at least two
    ring depths long (or all n) so that its ring runs full."""
    n_runs = max(1, min(pes, -(-n // (2 * distance))))
    return -(-n // n_runs)


def stream_runs(n_pos: int, distance: int, smem_bytes: int, sms: int) -> int:
    """Blocks of K5, each walking one run of the stream (the kernel splits
    the n_pos positions evenly): one for each block the card holds at once
    (as many as fit an SM's shared memory, on every SM), but no more than
    leave each run two ring depths, so its ring runs full."""
    per_sm = max(1, SMEM_PER_SM_BYTES // (smem_bytes + 1024))
    return max(1, min(per_sm * sms, n_pos // (2 * distance)))


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
    plan = gather_bulk_plan(cfg, rows_per_req=rows_per_req,
                            row_bytes=row_bytes)
    out = torch.empty((n * rows_per_req, W), dtype=table.dtype,
                      device=table.device)
    if n == 0:
        return out
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    rc = lib("pul_gather").pul_gather(
        _ptr(table), _ptr(trace), _ptr(out), n, rows_per_req * row_bytes,
        plan.chunk_bytes,
        stream_runs(n * plan.n_chunks, plan.distance, plan.smem_bytes, sms),
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
