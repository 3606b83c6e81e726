"""Architecture registry: the 10 assigned configs (port of `repro.configs`).

Use ``repro_torch.configs.get(name)``.  Each file is a copy of its reference.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as _llama4
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _dsv2
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.yi_6b import CONFIG as _yi
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3
from repro_torch.configs.internlm2_1_8b import CONFIG as _internlm2
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in [
    _llama4, _dsv2, _chameleon, _yi, _qwen2, _qwen3, _internlm2,
    _zamba2, _hubert, _mamba2,
]}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
