"""Tiled matrix product with PUL-streamed operands (K10).

:func:`pul_matmul` replaces the reference's ``kernels/pul_matmul.py::
pul_matmul``: C = A B in (bm, bn) output tiles with fp32 accumulation and an
``out_dtype`` cast, the A and B tiles streamed along K through a preload
ring (the paper's Fig. 1 roofline argument at tile granularity). The kernel
is CUDA C++ for Hopper, ``csrc/pul_matmul.cu`` (see the note at its head),
with two bodies that :func:`matmul_body` chooses from the arguments:

  * ``"wgmma"``: bf16 inputs with bm in (64, 128) and bn in (32, 64, 128).
    Tensor cores (wgmma, fp32 accumulate) fed by TMA through an mbarrier
    ring of K chunks, planned by :func:`matmul_tc_plan`.
  * ``"fma"``: everything else (f32 inputs, bm = 32). fp32 FMAs on the CUDA
    cores, no TF32; the ring streams chunks of K that
    :func:`matmul_ring_plan` picks so the slots fit shared memory.

The choice is a rule on the arguments, not a fallback: a build or launch
failure of either body raises.

Beside it is the plain version :func:`matmul_ref`, the fp32 product (the
reference's ``kernels/ref.py::matmul_ref``). The wrapper takes it only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES["k10"]`` counts the launches of both bodies,
``LAUNCHES["k10_wgmma"]`` those of the tensor-core body.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.pul import CP_ASYNC_BYTES, IssueStrategy, PULConfig
from repro_torch.kernels._runtime import (
    LAUNCHES,
    SMEM_LIMIT_BYTES,
    _check,
    _plan,
    _ptr,
    _raise_on,
    _stream,
    lib,
)

#: output tile sides the kernel is built for (16 x {2, 4, 8} per thread row)
TILES = (32, 64, 128)
#: input and output types the kernel takes
DTYPES = (torch.float32, torch.bfloat16)
#: output tile sides the tensor-core body takes (bf16 inputs)
TC_BM = (64, 128)
TC_BN = (32, 64, 128)
#: K columns a tensor-core ring position may hold: one 128-, 64- or 32-byte
#: swizzled row of bf16
TC_CHUNKS = (64, 32, 16)
#: bytes the tensor-core body keeps to align its tiles to the swizzle's
#: 1024-byte atom
TC_ALIGN = 1024
#: the two mbarriers (full, empty) of one tensor-core ring slot
TC_BARRIER_BYTES = 16


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    distance: int       # K chunks preloaded ahead of the FMAs
    slots: int          # ring slots, each one A chunk and one B chunk
    smem_bytes: int     # dynamic shared memory of one block
    bk_chunk: int       # K columns of one ring position (divides bk)


def matmul_ring_plan(cfg: PULConfig, *, bm: int, bk: int, bn: int,
                     itemsize: int) -> MatmulPlan:
    """K10's ring: a position is a chunk of bk_chunk columns of the (bm, bk)
    A tile and rows of the (bk, bn) B tile. bk_chunk is the largest of bk,
    bk / 2, bk / 4, ... (each whole 16-byte granules) whose ring of the
    slots PULConfig asks for (2d BATCH, d + 1 SEQUENTIAL) fits shared
    memory; when none does, the smallest, with distance and slots clamped as
    for K1-K5. At the default (128, 128, 128) f32 tiles and d = 4 that is
    bk_chunk 16: 8 slots of 16 KB."""
    unit = CP_ASYNC_BYTES // itemsize
    if bk < unit or bk % unit:
        raise ValueError(f"a K tile of {bk} values is not whole 16-byte "
                         "cp.async granules")
    chunk = bk
    while ((bm + bn) * chunk * itemsize * cfg.num_slots > SMEM_LIMIT_BYTES
           and chunk % 2 == 0 and (chunk // 2) % unit == 0):
        chunk //= 2
    ring = _plan(cfg, 0, (bm + bn) * chunk * itemsize,
                 f"a ({bm}, {chunk}) + ({chunk}, {bn}) tile chunk pair")
    return MatmulPlan(ring.distance, ring.slots, ring.smem_bytes, chunk)


def matmul_body(dtype: torch.dtype, bm: int, bn: int) -> str:
    """The kernel body that runs a product of `dtype` inputs in (bm, bn)
    output tiles: "wgmma" (tensor cores) for bf16 with bm in TC_BM and bn in
    TC_BN, else "fma" (CUDA cores)."""
    if dtype == torch.bfloat16 and bm in TC_BM and bn in TC_BN:
        return "wgmma"
    return "fma"


def matmul_tc_plan(cfg: PULConfig, *, bm: int, bk: int,
                   bn: int) -> MatmulPlan:
    """The tensor-core body's ring: a position is one K chunk of bk_chunk
    columns, the largest of TC_CHUNKS that divides bk (64 bf16 is one
    128-byte swizzled row), holding the (bm, bk_chunk) A tile and the
    (bk_chunk, bn) B tile beside their full and empty mbarriers. Distance
    and slots come from PULConfig (2d BATCH, d + 1 SEQUENTIAL), clamped to
    227 KB with TC_ALIGN bytes of alignment. At the default (128, 128, 128)
    tiles and d = 4 that is 7 slots of 32 KB."""
    chunk = next((c for c in TC_CHUNKS if bk % c == 0), None)
    if chunk is None:
        raise ValueError(f"a K tile of {bk} values is not whole chunks of "
                         f"{TC_CHUNKS[-1]}")
    ring = _plan(cfg, TC_ALIGN, (bm + bn) * chunk * 2 + TC_BARRIER_BYTES,
                 f"a ({bm}, {chunk}) + ({chunk}, {bn}) bf16 tile pair")
    return MatmulPlan(ring.distance, ring.slots, ring.smem_bytes, chunk)


# ---------------------------------------------------------------------- #
# plain version
# ---------------------------------------------------------------------- #
def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fp32 product of a and b."""
    return a.float() @ b.float()


# ---------------------------------------------------------------------- #
# kernel wrapper
# ---------------------------------------------------------------------- #
def pul_matmul(a: torch.Tensor, b: torch.Tensor, *,
               cfg: PULConfig = PULConfig(), bm: int = 128, bk: int = 128,
               bn: int = 128, out_dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """K10: C = A B, a (M, K) and b (K, N) of one type, M, K, N multiples of
    bm, bk, bn. Returns (M, N) in out_dtype. CPU tensors take the plain
    version (cast to out_dtype); CUDA tensors launch the kernel, which takes
    f32 or bf16 inputs, f32 or bf16 output, and bm, bn in TILES: bf16 with
    bm in TC_BM and bn in TC_BN on the tensor-core body, the rest on the
    CUDA-core body (:func:`matmul_body`)."""
    M, K = a.shape
    K2, N = b.shape
    if K != K2 or M % bm or K % bk or N % bn:
        raise ValueError(f"({M}, {K}) x ({K2}, {N}) does not divide into "
                         f"({bm}, {bk}, {bn}) tiles")
    if a.device.type == "cpu":
        return matmul_ref(a, b).to(out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"the matmul kernel runs on CUDA tensors, got "
                         f"{a.device}")
    if a.dtype not in DTYPES or out_dtype not in DTYPES:
        raise TypeError(f"inputs of {a.dtype} to {out_dtype}: the kernel "
                        f"takes {', '.join(map(str, DTYPES))}")
    if bm not in TILES or bn not in TILES:
        raise ValueError(f"output tiles ({bm}, {bn}): the kernel is built "
                         f"for sides {TILES}")
    _check("a", a, (M, K), a.dtype, a.device)
    _check("b", b, (K, N), a.dtype, a.device)
    item = a.element_size()
    if (N * item) % CP_ASYNC_BYTES or (K * item) % CP_ASYNC_BYTES or \
            a.data_ptr() % CP_ASYNC_BYTES or b.data_ptr() % CP_ASYNC_BYTES:
        raise ValueError("rows of a and b must be whole 16-byte granules on "
                         "16-byte boundaries")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    seq = int(cfg.strategy is IssueStrategy.SEQUENTIAL)
    if matmul_body(a.dtype, bm, bn) == "wgmma":
        plan = matmul_tc_plan(cfg, bm=bm, bk=bk, bn=bn)
        rc = lib("pul_matmul").pul_matmul_wgmma(
            _ptr(a), _ptr(b), _ptr(out), M, N, K, bm, bn, plan.bk_chunk,
            plan.distance, plan.slots, seq, int(out_dtype == torch.bfloat16),
            plan.smem_bytes, _stream(a))
        _raise_on(rc, "pul_matmul_wgmma")
        LAUNCHES["k10_wgmma"] += 1
    else:
        plan = matmul_ring_plan(cfg, bm=bm, bk=bk, bn=bn, itemsize=item)
        rc = lib("pul_matmul").pul_matmul(
            _ptr(a), _ptr(b), _ptr(out), M, N, K, bm, bn, plan.bk_chunk,
            plan.distance, plan.slots, seq, DTYPES.index(a.dtype),
            int(out_dtype == torch.bfloat16), plan.smem_bytes, _stream(a))
        _raise_on(rc, "pul_matmul")
    LAUNCHES["k10"] += 1
    return out
