"""MusicGen-large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]. 48L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192
vocab=2048 (EnCodec codebook). The conditioning frontend is a stub: the
caller supplies precomputed conditioning embeddings (B, 64, d_model), which
prefill prepends to the token stream; the backbone has sinusoidal
positions and a non-gated GELU MLP (4x widening), as in audiocraft.

Field for field the reference's ``repro/configs/musicgen_large.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    pattern=("global",),
    train_accum=4,
    mlp_type="gelu",
    pos_embedding="sinusoidal",
    frontend="cond_stub",
    frontend_tokens=64,
)
