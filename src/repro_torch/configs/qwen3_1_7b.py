"""Qwen3-1.7B — dense, GQA, per-head RMS qk_norm, no qkv bias.

[hf:Qwen/Qwen3-8B family; hf]. 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, head_dim 128, rope theta 1e6, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    pattern=("global",),
    train_accum=2,
    mlp_type="swiglu",
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
)
