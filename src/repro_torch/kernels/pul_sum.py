"""The paper's SUM microbenchmark (K8): trace-driven random aggregation.

:func:`pul_sum` replaces the reference's ``kernels/pul_sum.py::pul_sum``:
the fp32 sum of ``data[trace[i]*r : +r]`` over every request i of the trace
(r = rows_per_req), the paper's Exps. 1, 3 and 4, whose knobs are the
preload distance, the transfer size (rows per request) and the issue order.
The kernel is CUDA C++ for Hopper, ``csrc/pul_sum.cu`` (see the note at its
head): the trace is cut into runs, each walked by one PE, a lane group with
its own preload ring, and the partial sums are added in a fixed order.

Beside it is the plain version :func:`sum_ref` (the reference's
``kernels/ref.py::sum_ref``). The wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES["k8"]`` counts its launches. :func:`sum_ring_plan` sizes the PE
and budgets its ring against shared memory; the trace is cut into one run
per PE the card holds at once (``pul_gather.split_runs``, as K5 and K9 cut
their streams).
"""
from __future__ import annotations

import dataclasses

import torch

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

#: threads of one block (the source's kThreads)
THREADS = 128
#: lanes of a warp, the most a PE spans
WARP = 32
#: element types the kernel reads (the reference's tests: f32, bf16)
DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class SumPlan:
    distance: int       # requests preloaded ahead of the adds, per PE
    slots: int          # ring slots of each PE
    smem_bytes: int     # dynamic shared memory of one block
    lanes: int          # lanes of one PE
    per_lane: int       # 16-byte granules each lane copies per request

    @property
    def pes_per_block(self) -> int:
        return THREADS // self.lanes


def sum_ring_plan(cfg: PULConfig, *, req_bytes: int) -> SumPlan:
    """K8's PE and ring: a PE is the largest power of two of lanes, at most a
    warp, not above the request's 16-byte granules; each lane copies
    ceil(granules / lanes) of them. A ring position of the block is one
    request of each of its PEs; distance and slots are clamped to shared
    memory and to the 32-entry wait table as for K1-K5. Raises for a request
    that is not whole 16-byte cp.async granules, or above 56 KB, when one
    slot of four PEs does not fit."""
    if req_bytes < CP_ASYNC_BYTES or req_bytes % CP_ASYNC_BYTES:
        raise ValueError(
            f"a request of {req_bytes} B is not a whole number of "
            f"{CP_ASYNC_BYTES}-byte cp.async granules")
    granules = req_bytes // CP_ASYNC_BYTES
    lanes = min(WARP, 1 << (granules.bit_length() - 1))
    per_lane = -(-granules // lanes)
    ring = _plan(cfg, 0, THREADS * per_lane * CP_ASYNC_BYTES,
                 f"a ring position of {THREADS // lanes} requests of "
                 f"{req_bytes} B")
    return SumPlan(ring.distance, ring.slots, ring.smem_bytes, lanes,
                   per_lane)


# ---------------------------------------------------------------------- #
# plain version
# ---------------------------------------------------------------------- #
def sum_ref(data: torch.Tensor, trace: torch.Tensor) -> torch.Tensor:
    """Trace-driven aggregation (the paper's SUM): the fp32 sum of the rows
    of `data` that `trace` selects, with repetition."""
    return data[trace.long()].float().sum()


# ---------------------------------------------------------------------- #
# kernel wrapper
# ---------------------------------------------------------------------- #
def pul_sum(data: torch.Tensor, trace: torch.Tensor, *,
            cfg: PULConfig = PULConfig(),
            rows_per_req: int = 1) -> torch.Tensor:
    """K8: the fp32 sum of data[trace[i]*r : +r] over all i, r =
    rows_per_req.

    data (R * r, W) f32 / bf16; trace (n,) int32 request ids in [0, R).
    Returns a 0-dim f32 tensor. CPU tensors take the plain version; CUDA
    tensors launch the kernel, which needs requests of whole 16-byte
    granules."""
    RR, W = data.shape
    if rows_per_req < 1 or RR % rows_per_req:
        raise ValueError(f"{RR} table rows are not whole requests of "
                         f"{rows_per_req} rows")
    R = RR // rows_per_req
    if data.device.type == "cpu":
        return sum_ref(data.reshape(R, rows_per_req * W), trace)
    if data.device.type != "cuda":
        raise ValueError(f"the SUM kernel runs on CUDA tensors, got "
                         f"{data.device}")
    if data.dtype not in DTYPES:
        raise TypeError(f"data has dtype {data.dtype}, the kernel takes "
                        f"{', '.join(map(str, DTYPES))}")
    n = trace.shape[0]
    _check("data", data, (RR, W), data.dtype, data.device)
    _check("trace", trace, (n,), torch.int32, data.device)
    if data.data_ptr() % CP_ASYNC_BYTES:
        raise ValueError("data must start on a 16-byte boundary")
    plan = sum_ring_plan(cfg, req_bytes=rows_per_req * W * data.element_size())
    out = torch.zeros((), dtype=torch.float32, device=data.device)
    if n == 0:
        return out
    code = DTYPES.index(data.dtype)
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    pes = (sms * _blocks_per_sm("pul_sum", code, plan.smem_bytes)
           * plan.pes_per_block)
    run = split_runs(n, plan.distance, pes)
    grid = -(-(-(-n // run)) // plan.pes_per_block)
    partials = torch.empty(grid, dtype=torch.float32, device=data.device)
    rc = lib("pul_sum").pul_sum(
        _ptr(data), _ptr(trace), _ptr(partials), _ptr(out), n,
        rows_per_req * W * data.element_size(), plan.lanes, plan.per_lane,
        run, grid, plan.distance, plan.slots,
        int(cfg.strategy is IssueStrategy.SEQUENTIAL), plan.smem_bytes, code,
        _stream(data))
    _raise_on(rc, "pul_sum")
    LAUNCHES["k8"] += 1
    return out
