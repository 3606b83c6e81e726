"""Prefill / decode step factories (port of the serving half of
`repro.launch.steps`).

`input_specs` gives each model input of a shape cell as a shape and a dtype;
`make_prefill_step` and `make_decode_step` return the functions a server
calls.  The single-device port has no sharding arguments.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeConfig


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Spec]:
    """Shape and dtype of every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":    # one new token against a seq_len cache
        return {"token": Spec((b, 1), torch.int32), "cache_pos": Spec((), torch.int32)}
    if cfg.family == "audio":
        specs = {"inputs": Spec((b, s, cfg.frontend_dim), torch.float32)}
    else:
        specs = {"inputs": Spec((b, s), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = Spec((b, s), torch.int32)
    return specs


def make_prefill_step(cfg: ModelConfig):
    if cfg.is_encoder:
        # Encoder-only archs have no decode, hence no cache: "prefill" is the
        # full bidirectional forward (the serving operation for hubert).
        def encode_step(params, batch):
            return M.forward_train(params, batch["inputs"])
        return encode_step

    def prefill_step(params, caches, batch):
        return M.forward_prefill(params, batch["inputs"], caches)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, caches, batch):
        return M.forward_decode(params, batch["token"], caches, batch["cache_pos"])
    return serve_step
