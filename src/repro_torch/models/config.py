"""Model configuration for the architecture zoo (port of `repro.models.config`).

One frozen dataclass covers every assigned family (dense / moe / vlm / audio /
ssm / hybrid); family-specific fields are zero/None when unused.  Configs for
the 10 assigned architectures live in ``repro_torch.configs`` — this module
only defines the schema and the reduced smoke-test scaling helper.  It is a
copy of the reference's (which imports no JAX either): the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # attention flavour
    qkv_bias: bool = False          # qwen2
    qk_norm: bool = False           # qwen3
    causal: bool = True             # False for encoder-only (hubert)

    # MLA (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0            # 0 -> full-rank q projection
    rope_head_dim: int = 64         # decoupled-RoPE dims per head

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_layer_step: int = 1         # MoE every k-th layer (llama4: 2)
    first_dense_layers: int = 0     # deepseek: 1
    capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # hybrid (zamba2): one shared attention block applied every k ssm layers
    shared_attn_every: int = 0

    # frontend stub (vlm/audio): input embeddings arrive precomputed
    frontend_dim: int = 0           # e.g. VQ codebook / audio feature dim

    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def supports_decode(self) -> bool:
        return self.causal

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context without O(S^2) attention and
        O(S) KV cache?  True for pure-SSM; hybrid zamba2's shared attention
        has a KV cache but only at 13 application sites — we count it in."""
        return self.family in ("ssm", "hybrid")

    def reduced(self, layers: int = 2, d_model: int = 64,
                vocab: int = 256) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(heads, self.num_kv_heads))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=layers, d_model=d_model,
            num_heads=heads, num_kv_heads=kv, head_dim=d_model // heads,
            d_ff=d_model * 2, vocab_size=vocab,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.use_mla else 0,
            q_lora_rank=0,
            rope_head_dim=16 if self.use_mla else self.rope_head_dim,
            num_experts=min(self.num_experts, 8),
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2),
            moe_d_ff=d_model * 2 if self.num_experts else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32,
            shared_attn_every=2 if self.shared_attn_every else 0,
            frontend_dim=min(self.frontend_dim, 32) if self.frontend_dim else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)


def shape_applicability(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; otherwise the skip reason
    (recorded verbatim in EXPERIMENTS.md §Dry-run)."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "pure full-attention arch; 500k dense decode excluded per assignment"
    return None
