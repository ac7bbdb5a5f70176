"""DeepSeek-V2-236B — MLA (kv_lora=512) + MoE (2 shared + 160 routed, top-6).

[arXiv:2405.04434; hf]. 60L d_model=5120 128H d_ff(expert)=1536 vocab=102400.
MLA: q_lora 1536, kv_lora 512, qk_nope 128 + qk_rope 64, v_head 128.
Layer 0 is dense (first_dense_layers=1), remaining 59 are MoE.
Paged decode runs the absorbed MLA path (K3/K4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=192,                  # qk_nope (128) + qk_rope (64)
    d_ff=12288,                    # dense layer-0 FFN (DeepSeek-V2 inter size)
    vocab_size=102400,
    pattern=("moe",),
    first_dense_layers=1,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=160,
    experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    train_accum=16,
    bf16_moments=True,
    mlp_type="swiglu",
    moe_backend="gather",   # sort-based dispatch; einsum backend costs ~2x FLOPs at E=160
)
