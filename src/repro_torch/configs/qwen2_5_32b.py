"""Qwen2.5-32B — dense, GQA with QKV bias.

[hf:Qwen/Qwen2.5 family; hf]. 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, head_dim 128, rope theta 1e6.

40 query heads over 8 kv heads: a group of 5, which K1/K2 hold whole
(the reference's note on the 16-way model axis, ``repro/runtime/
sharding.py``, concerns its mesh; the port serves on one card).

Field for field the reference's ``repro/configs/qwen2_5_32b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    pattern=("global",),
    train_accum=16,
    mlp_type="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
)
