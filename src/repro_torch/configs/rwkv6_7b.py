"""RWKV6-7B (Finch) — attention-free, data-dependent per-channel decay.

[arXiv:2404.05892; hf]. 32L d_model=4096 d_ff=14336 vocab=65536. WKV heads:
64 heads x 64 head_dim; token-shift mixing; channel-mix FFN (relu^2).
Runs long_500k: state is O(1) in sequence length.

Field for field the reference's ``repro/configs/rwkv6_7b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=14336,
    vocab_size=65536,
    pattern=("rwkv",),
    attn_type="none",
    train_accum=4,
    mlp_type="rwkv_cmix",
    ssm_heads=64,
    ssm_head_dim=64,
    chunk_size=32,
)
