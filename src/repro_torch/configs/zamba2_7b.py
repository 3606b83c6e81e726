"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

Assigned spec: 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000,
ssm_state=64.  [arXiv:2411.15242; unverified]

81 Mamba2 layers with ONE shared attention+MLP block (weights shared) applied
every 6th layer — 13 application sites, each with its own KV cache.  Zamba2's
per-site LoRA specialisation of the shared block is omitted (DESIGN.md §5).
Sub-quadratic decode: runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
)
