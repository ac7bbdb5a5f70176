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

__all__ = [
    "LAUNCHES", "NEG_INF", "RingPlan", "mla_ring_plan", "ring_plan",
    "pul_paged_decode_attention", "pul_paged_sweep_decode_attention",
    "pul_paged_mla_decode_attention", "pul_paged_sweep_mla_decode_attention",
    "paged_decode_attention_ref", "paged_sweep_decode_attention_ref",
    "paged_mla_decode_attention_ref", "paged_sweep_mla_decode_attention_ref",
]
