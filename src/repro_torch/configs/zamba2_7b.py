"""Zamba2-7B — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; unverified]. 81L d_model=3584 32H (MHA) d_ff=14336
vocab=32000, ssm_state=64. Pattern: (mamba, mamba, shared_attn) x 27 — the
attention+MLP block weights are SHARED across all 27 invocations, each
invocation adding its own low-rank (LoRA, r=128) adapter on the q/k/v
projections, following the Zamba2 design. Mamba2: d_inner=2*d_model=7168,
112 heads x 64 head_dim, state 64, conv kernel 4.
Runs long_500k: hybrid family (SSM state O(1); the shared attention's KV
grows with the sequence).

Field for field the reference's ``repro/configs/zamba2_7b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    pattern=("mamba", "mamba", "shared_attn"),
    train_accum=4,
    mlp_type="swiglu",
    ssm_state=64,
    ssm_heads=112,
    ssm_head_dim=64,
    d_inner=7168,
    conv_kernel=4,
    chunk_size=32,
    shared_lora_rank=128,
)
