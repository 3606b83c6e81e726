"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

Assigned spec: 48L d_model=2048 (attn-free) d_ff=0 vocab=50280,
ssm_state=128.  [arXiv:2405.21060; unverified]

Pure SSM: O(1)-state decode, runs the long_500k cell.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,  # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
)
