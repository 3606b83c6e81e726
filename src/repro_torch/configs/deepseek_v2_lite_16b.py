"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, shared+routed MoE.

Assigned spec: 27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
MoE 64e top-6 — MLA kv_lora=512, "2 shared+160 routed top-6".
[arXiv:2405.04434; hf]

The assignment note "160 routed" conflicts with its own "MoE 64e": we follow
DeepSeek-V2-Lite ground truth — 64 routed + 2 shared experts, top-6, first
layer dense (d_ff=10944) — and record the discrepancy in DESIGN.md §5.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,       # MLA is effectively MHA over compressed KV
    head_dim=128,
    d_ff=10944,            # the single dense (first) layer
    vocab_size=102_400,
    use_mla=True,
    kv_lora_rank=512,
    rope_head_dim=64,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    moe_layer_step=1,
    first_dense_layers=1,
)
