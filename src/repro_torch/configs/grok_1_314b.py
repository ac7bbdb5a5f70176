"""Grok-1-314B — MoE, 8 experts top-2.

[hf:xai-org/grok-1; unverified]. 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, head_dim 128, gated-GELU experts, attention logit softcap 30
(grok uses a tanh attn-logit clamp), embeddings scaled.

The MoE dispatch is the ``einsum`` backend (the config default), and the
router takes top-k over the logits, then a softmax over the k: the model
picks that routing by its name (``models/moe.py::_route``), so the name
stays ``grok-...`` in every variant, reduced included.

Field for field the reference's ``repro/configs/grok_1_314b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    pattern=("moe",),
    attn_softcap=30.0,
    num_experts=8,
    experts_per_tok=2,
    moe_d_ff=32768,
    train_accum=16,
    bf16_moments=True,
    mlp_type="geglu",
    embed_scale=True,
    tie_embeddings=True,
)
