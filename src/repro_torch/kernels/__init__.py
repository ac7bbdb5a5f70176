"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``)."""
from repro_torch.kernels import ref
from repro_torch.kernels.pul_attention import (
    LAUNCHES,
    NEG_INF,
    RingPlan,
    SplitPlan,
    attention_body,
    attention_f32_tiles,
    attention_kernel_ref,
    attention_ring_plan,
    attention_tc_plan,
    mla_split_plan,
    paged_decode_attention_ref,
    paged_decode_split_ref,
    paged_mla_decode_attention_ref,
    paged_mla_decode_split_ref,
    paged_split_plan,
    paged_sweep_decode_attention_ref,
    paged_sweep_mla_decode_attention_ref,
    pul_attention,
    pul_paged_decode_attention,
    pul_paged_mla_decode_attention,
    pul_paged_sweep_decode_attention,
    pul_paged_sweep_mla_decode_attention,
)
from repro_torch.kernels.pul_decode import (
    DecodePlan,
    decode_attention_kernel_ref,
    decode_attention_split_ref,
    decode_pieces,
    decode_ring_plan,
    pul_decode_attention,
)
from repro_torch.kernels.pul_filter import (
    FilterPlan,
    filter_materialize_ref,
    filter_ref,
    filter_ring_plan,
    pul_filter,
)
from repro_torch.kernels.pul_gather import (
    GatherPlan,
    gather_ref,
    gather_bulk_plan,
    page_gather_ref,
    pul_gather,
    pul_page_gather,
)
from repro_torch.kernels.pul_matmul import (
    MatmulPlan,
    matmul_body,
    matmul_fma_block_n,
    matmul_fma_tiles,
    matmul_ref,
    matmul_ring_plan,
    matmul_tc_plan,
    pul_matmul,
)
from repro_torch.kernels.pul_sum import SumPlan, pul_sum, sum_ref, sum_ring_plan

#: CUDA sources under csrc/: K1/K2, the MLA pair K3/K4, the gather K5, the
#: dense attention pair K6/K7, and the paper's microbenchmarks K8 (SUM), K9
#: (filter) and K10 (matmul)
SOURCES = ("pul_paged_decode", "pul_paged_mla_decode", "pul_gather",
           "pul_dense_attention", "pul_sum", "pul_filter", "pul_matmul")

__all__ = [
    "LAUNCHES", "NEG_INF", "SOURCES", "RingPlan", "mla_split_plan", "SplitPlan",
    "paged_split_plan", "paged_decode_split_ref", "paged_mla_decode_split_ref",
    "ref", "attention_ring_plan", "attention_tc_plan", "attention_body",
    "attention_f32_tiles",
    "pul_attention", "attention_kernel_ref",
    "DecodePlan", "decode_ring_plan", "decode_pieces", "pul_decode_attention",
    "decode_attention_kernel_ref", "decode_attention_split_ref",
    "pul_paged_decode_attention", "pul_paged_sweep_decode_attention",
    "pul_paged_mla_decode_attention", "pul_paged_sweep_mla_decode_attention",
    "paged_decode_attention_ref", "paged_sweep_decode_attention_ref",
    "paged_mla_decode_attention_ref", "paged_sweep_mla_decode_attention_ref",
    "GatherPlan", "gather_bulk_plan", "pul_gather", "pul_page_gather",
    "gather_ref", "page_gather_ref",
    "SumPlan", "sum_ring_plan", "pul_sum", "sum_ref",
    "FilterPlan", "filter_ring_plan", "pul_filter", "filter_ref",
    "filter_materialize_ref",
    "MatmulPlan", "matmul_ring_plan", "matmul_tc_plan", "matmul_body",
    "matmul_fma_tiles", "matmul_fma_block_n",
    "pul_matmul", "matmul_ref",
]
