"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``)."""
from repro_torch.kernels.pul_attention import (
    LAUNCHES,
    NEG_INF,
    RingPlan,
    mla_ring_plan,
    paged_decode_attention_ref,
    paged_mla_decode_attention_ref,
    paged_sweep_decode_attention_ref,
    paged_sweep_mla_decode_attention_ref,
    pul_paged_decode_attention,
    pul_paged_mla_decode_attention,
    pul_paged_sweep_decode_attention,
    pul_paged_sweep_mla_decode_attention,
    ring_plan,
)
from repro_torch.kernels.pul_gather import (
    GatherPlan,
    gather_ref,
    gather_ring_plan,
    page_gather_ref,
    pul_gather,
    pul_page_gather,
)

#: CUDA sources under csrc/: K1/K2, the MLA pair K3/K4, and the gather K5
SOURCES = ("pul_paged_decode", "pul_paged_mla_decode", "pul_gather")

__all__ = [
    "LAUNCHES", "NEG_INF", "SOURCES", "RingPlan", "mla_ring_plan", "ring_plan",
    "pul_paged_decode_attention", "pul_paged_sweep_decode_attention",
    "pul_paged_mla_decode_attention", "pul_paged_sweep_mla_decode_attention",
    "paged_decode_attention_ref", "paged_sweep_decode_attention_ref",
    "paged_mla_decode_attention_ref", "paged_sweep_mla_decode_attention_ref",
    "GatherPlan", "gather_ring_plan", "pul_gather", "pul_page_gather",
    "gather_ref", "page_gather_ref",
]
