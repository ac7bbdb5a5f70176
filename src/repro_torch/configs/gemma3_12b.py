"""Gemma3-12B — 5:1 local:global attention, 128k context, qk_norm.

[hf:google/gemma-3 family; unverified]. 48L d_model=3840 16H (GQA kv=8)
d_ff=15360 vocab=262144. head_dim 256, sliding window 1024 on local layers,
global layers rope theta 1e6 (local 1e4), GeGLU, tied scaled embeddings,
no softcap (replaced by qk_norm in gemma3).

Field for field the reference's ``repro/configs/gemma3_12b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    train_accum=8,
    mlp_type="geglu",
    qk_norm=True,
    sliding_window=1024,
    rope_theta=1e6,
    local_rope_theta=1e4,
    tie_embeddings=True,
    embed_scale=True,
    sandwich_norm=True,
)
