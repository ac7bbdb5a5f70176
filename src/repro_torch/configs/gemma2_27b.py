"""Gemma2-27B — local/global alternating attention, logit softcaps.

[arXiv:2408.00118; hf]. 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000. head_dim 128, sliding window 4096 on local layers, attention
logit softcap 50, final logit softcap 30, GeGLU MLP, tied embeddings scaled
by sqrt(d_model).

Field for field the reference's ``repro/configs/gemma2_27b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=("local", "global"),
    train_accum=8,
    mlp_type="geglu",
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    rope_theta=1e4,
    tie_embeddings=True,
    embed_scale=True,
    sandwich_norm=True,
)
