"""chameleon-34b [vlm] — early-fusion, VQ image tokens.

Assigned spec: 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
[arXiv:2405.09818; unverified]

Early fusion means images arrive as VQ-VAE token ids inside the same
vocabulary — the modality frontend (VQ tokenizer) is a stub: `input_specs()`
provides token ids directly, the backbone is a standard GQA decoder.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65_536,
)
