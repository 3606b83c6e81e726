"""llama4-maverick-400b-a17b [moe] — MoE, early fusion.

Assigned spec: 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 128e top-1.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

To reach ~400B total with 8192-wide experts we interleave MoE every 2nd layer
(Maverick's interleave_moe_layer_step=2) with 16384-wide dense layers and one
shared expert — parameter audit in DESIGN.md §5.  ~400B total / ~17B active.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,            # dense interleaved layers
    vocab_size=202_048,
    num_experts=128,
    num_shared_experts=1,
    top_k=1,
    moe_d_ff=8192,         # assigned d_ff applies to the experts
    moe_layer_step=2,
    rope_theta=500_000.0,
)
