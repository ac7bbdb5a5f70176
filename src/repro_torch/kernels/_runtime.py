"""What every kernel wrapper of the port shares: the loaded libraries and
their C signatures, the launch counts, the shared-memory ring budget, and
the argument checks.

A source's library is built and loaded at its first launch (``lib``), never
when a module is imported: the CPU tests import every kernel module without
nvcc or a card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional

import torch

from repro_torch.core.pul import IssueStrategy, PULConfig

#: dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT_BYTES = 232448
#: deepest preload distance the kernels' cp.async.wait_group table covers
MAX_RING_DISTANCE = 32
#: kernel launches so far, by kernel ("k1"/"k3": sweep, "k2"/"k4": per-layer
#: paged decode; "k5": the gather; "k6": dense decode attention; "k7": flash
#: attention; "k8", "k9", "k10": the paper's microbenchmarks). "k7_tc" and
#: "k10_wgmma" count the launches of K7's and K10's tensor-core bodies, which
#: "k7" and "k10" count too.
LAUNCHES = {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": 0, "k6": 0, "k7": 0,
            "k8": 0, "k9": 0, "k10": 0, "k7_tc": 0, "k10_wgmma": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
#: C signature of every entry point, by source (all return an int: 0 or the
#: launch's CUDA error)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "pul_paged_decode": {
        "pul_paged_sweep_decode": [_P] * 13 + [_I] * 9 + [_F, _F] + [_I] * 5 + [_P],
        "pul_paged_decode": [_P] * 11 + [_I] * 7 + [_F, _F] + [_I] * 5 + [_P],
    },
    "pul_paged_mla_decode": {
        "pul_paged_sweep_mla_decode": [_P] * 14 + [_I] * 9 + [_F] + [_I] * 4 + [_P],
        "pul_paged_mla_decode": [_P] * 12 + [_I] * 7 + [_F] + [_I] * 4 + [_P],
    },
    "pul_gather": {"pul_gather": [_P] * 3 + [_I, _L] + [_I] * 6 + [_P]},
    "pul_sum": {"pul_sum": [_P] * 4 + [_I] * 11 + [_P],
                "pul_sum_blocks_per_sm": [_I, _I]},
    "pul_filter": {"pul_filter": [_P, _P, _F] + [_I] * 15 + [_P],
                   "pul_filter_blocks_per_sm": [_I] * 3},
    "pul_matmul": {"pul_matmul": [_P] * 3 + [_I] * 12 + [_P],
                   "pul_matmul_wgmma": [_P] * 3 + [_I] * 11 + [_P],
                   "pul_matmul_blocks_per_sm": [_I] * 4},
    "pul_dense_attention": {
        "pul_flash_attention": [_P] * 4 + [_I] * 9 + [_F, _F] + [_I] * 5 + [_P],
        "pul_decode_attention": [_P] * 9 + [_I] * 6 + [_F, _F] + [_I] * 10 + [_P],
        "pul_dense_attention_blocks_per_sm": [_I] * 4,
        "pul_flash_attention_blocks_per_sm": [_I] * 2,
    },
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def lib(source: str) -> ctypes.CDLL:
    """The built library of ``csrc/<source>.cu``, its signatures set."""
    if source not in _LIBS:
        from repro_torch.kernels import _build
        cdll = _build.load(source)
        for fn, argtypes in SIGNATURES[source].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = _I
        _LIBS[source] = cdll
    return _LIBS[source]


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(source: str, *args: int,
                   query: Optional[str] = None) -> int:
    """Blocks of ``source``'s kernel one SM holds at once, from the
    library's occupancy query ``query`` (by default
    ``<source>_blocks_per_sm``)."""
    n = getattr(lib(source), query or f"{source}_blocks_per_sm")(*args)
    if n < 1:
        raise RuntimeError(f"{source} occupancy query failed: {n}")
    return n


@dataclasses.dataclass(frozen=True)
class RingPlan:
    distance: int       # blocks preloaded ahead of the compute
    slots: int          # ring slots
    smem_bytes: int     # dynamic shared memory of one block


def _plan(cfg: PULConfig, aux: int, slot: int, what: str,
          limit: int = SMEM_LIMIT_BYTES) -> RingPlan:
    """Clamp a PULConfig's ring of `slot`-byte slots beside `aux` bytes of
    other shared memory to what one Hopper block can hold (or to `limit`
    bytes, a kernel's share when several blocks are to fit an SM). Distance is
    clamped to the slots that fit and to ``MAX_RING_DISTANCE``; slots follow
    ``PULConfig.num_slots`` (2d for BATCH, d + 1 for SEQUENTIAL) within the
    same budget. Raises when not even one slot fits."""
    max_slots = (limit - aux) // slot
    seq = cfg.strategy is IssueStrategy.SEQUENTIAL
    d = min(cfg.distance, MAX_RING_DISTANCE, max_slots - (1 if seq else 0))
    if d < 1:
        raise ValueError(
            f"{what} of {slot} B does not fit the {limit} B of "
            "shared memory a block may use")
    want = cfg.slots if cfg.slots is not None else (d + 1 if seq else 2 * d)
    slots = min(max(want, d + 1 if seq else d), max_slots)
    return RingPlan(d, slots, slots * slot + aux)


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on t's card, for the launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
