"""ModelConfig: one dataclass describing every architecture in the zoo.

A config is *data only* — `models.zoo.build_model(config)` turns it into
(param tree, apply fns). Reduced smoke variants come from `config.reduced()`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) cell + which step it lowers."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer stacking: `pattern` repeats num_layers/len(pattern) times and is
    # lax.scan-ed; the first `first_dense_layers` are unscanned dense layers
    # (DeepSeek-V2 keeps layer 0 dense).
    pattern: Tuple[str, ...] = ("global",)   # global|local|moe|rwkv|mamba|shared_attn
    first_dense_layers: int = 0

    # attention flavor
    attn_type: str = "gqa"         # gqa | mla | none
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 1e4
    local_rope_theta: Optional[float] = None
    sliding_window: Optional[int] = None
    pos_embedding: str = "rope"    # rope | sinusoidal

    # MLP flavor
    mlp_type: str = "swiglu"       # swiglu | geglu | gelu | rwkv_cmix
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma multiplies embeddings by sqrt(d)
    sandwich_norm: bool = False    # gemma2/3 pre+post block norms

    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    moe_backend: str = "einsum"    # einsum | ragged (dispatch implementation)

    # MLA (DeepSeek-V2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = False       # absorbed-projection decode (optimized)

    # SSM / RWKV
    ssm_state: int = 0
    ssm_heads: int = 0             # wkv / mamba heads
    ssm_head_dim: int = 0
    d_inner: int = 0               # mamba expand dim
    conv_kernel: int = 4
    chunk_size: int = 32           # chunked-scan block length
    shared_lora_rank: int = 0      # zamba per-invocation LoRA on shared block

    # modality frontend STUB (assignment: precomputed embeddings)
    frontend: Optional[str] = None  # vit_stub | cond_stub
    frontend_tokens: int = 0

    # serving-time cache layout: paged_kv=True keeps EVERY attention layer's
    # cache dense and token-indexed (row r == token r, sliding windows become
    # an explicit decode-time mask instead of a ring). This is the layout the
    # paged-KV serving engine requires: pages map 1:1 onto token ranges for
    # every layer, so prefix pages are shareable across requests and a page
    # pool can evict/restore any range. Training/prefill math is unchanged.
    paged_kv: bool = False

    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    # training-time knobs
    remat: bool = True
    vocab_chunk: int = 16384       # chunked cross-entropy tile (PUL-style)
    train_accum: int = 8           # gradient-accumulation microbatches
    seq_shard_carry: bool = False  # remat-saved group carries sharded over
                                   # the model axis on the seq dim (REFUTED
                                   # on XLA SPMD — kept for the §Perf log)
    bf16_moments: bool = False     # Adam m/v in bf16 (giants: 6 B/param
                                   # saved; fp32 math inside the update)

    def __post_init__(self):
        scanned = self.num_layers - self.first_dense_layers
        if scanned % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: {scanned} scanned layers not divisible by "
                f"pattern {self.pattern}"
            )

    @property
    def padded_vocab(self) -> int:
        """Embedding/lm_head rows padded to a vocab_chunk multiple: shards
        cleanly over the model axis and removes the runtime pad+reshape in
        the chunked loss. Pad rows are never gathered (token ids < vocab)
        and are masked out of the loss/logits."""
        return -(-self.vocab_size // self.vocab_chunk) * self.vocab_chunk

    @property
    def num_groups(self) -> int:
        return (self.num_layers - self.first_dense_layers) // len(self.pattern)

    @property
    def supports_long_context(self) -> bool:
        """True if decode at 500k tokens is sub-quadratic / bounded-window.

        SSM & hybrid have O(1) state; gemma's sliding-window local layers
        bound the KV working set (global layers decode in O(S) per token).
        Pure full-attention archs skip long_500k (see DESIGN.md §5).
        """
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def shape_applicable(self, shape: InputShape) -> bool:
        if shape.name == "long_500k":
            return self.supports_long_context
        return True

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        scale = {}
        pat = len(self.pattern)
        scale["num_layers"] = self.first_dense_layers + max(1, 2 // pat) * pat
        scale["d_model"] = 64
        scale["num_heads"] = 4
        scale["num_kv_heads"] = min(self.num_kv_heads, 2) or 2
        if self.num_kv_heads == self.num_heads:
            scale["num_kv_heads"] = 4
        scale["head_dim"] = 16
        scale["d_ff"] = 128
        scale["vocab_size"] = 256
        scale["sliding_window"] = min(self.sliding_window, 16) if self.sliding_window else None
        if self.num_experts:
            scale["num_experts"] = min(self.num_experts, 8)
            scale["experts_per_tok"] = min(self.experts_per_tok, 2)
            scale["moe_d_ff"] = 32
        if self.q_lora_rank:
            scale["q_lora_rank"] = 32
        if self.kv_lora_rank:
            scale.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                         v_head_dim=16, head_dim=24)
        if self.ssm_heads:
            scale.update(ssm_heads=4, ssm_head_dim=16, ssm_state=16,
                         d_inner=128, chunk_size=8)
        if self.shared_lora_rank:
            scale["shared_lora_rank"] = 8
        if self.frontend_tokens:
            scale["frontend_tokens"] = 4
        scale["vocab_chunk"] = 64
        return dataclasses.replace(self, **scale)
