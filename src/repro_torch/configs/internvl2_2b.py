"""InternVL2-2B — InternLM2-1.8B language backbone + InternViT frontend.

[arXiv:2404.16821; hf]. 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553. The ViT frontend is a stub: the caller supplies precomputed
patch embeddings (B, 256, d_model), which prefill prepends to the token
stream (``Model.prefill(..., frontend_embeds=...)``); the serving engines
pass none.

Field for field the reference's ``repro/configs/internvl2_2b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    pattern=("global",),
    train_accum=2,
    mlp_type="swiglu",
    rope_theta=1e6,
    frontend="vit_stub",
    frontend_tokens=256,
)
