"""hubert-xlarge [audio] — encoder-only (wav2vec2 arch).

Assigned spec: 48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504.
[arXiv:2106.07447; unverified]

Encoder-only: bidirectional attention, no decode step (decode_32k/long_500k
cells are SKIPPED).  The conv waveform frontend is a stub: `input_specs()`
provides precomputed 512-dim frame embeddings; vocab 504 = masked-prediction
cluster targets.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    frontend_dim=512,
)
