"""Deterministic synthetic data pipeline (port of `repro.data.pipeline`).

Every batch is a pure function of (seed, step), so a restart from a
checkpoint resumes the exact stream with no data state to save.  The draws
come from the port's counter hash (`core.streams`): int64 operations that
give the same integers on the card and the CPU.  They are not the
reference's threefry numbers; the tests hand the reference's batches to
the port as numpy arrays.

Two sources: `random` tokens (uniform over the vocab) and `lm`, a Markov
stream with learnable structure: a class walks by steps in [-2, 3)
modulo `zipf_classes`, and each token lies in its class's band of
vocab // classes ids.  The audio family gets normal frame features and
integer labels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch import device as _device
from repro_torch.core import streams
from repro_torch.models.config import ModelConfig

_DATA_WORD = 0x4C4D            # keys the data stream apart from the simulator's draws
_STEPS, _OFFSETS, _TOKENS, _FEATURES, _FEATURES_2, _LABELS = range(6)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    kind: str = "lm"               # lm | random
    zipf_classes: int = 64         # markov state count for `lm`


def _words(seed: int, step: int, draw: int, shape, dev) -> torch.Tensor:
    """32-bit words (int64), one per element of `shape`, keyed by (seed,
    step, draw) and the element's flat index."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=dev)
    return streams._bits(streams._key(seed, _DATA_WORD, step, draw), idx).reshape(shape)


def _randint(words: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Integers in [lo, hi) from 32-bit words: the high half of words * n
    (exact in int64 for n < 2^31)."""
    return lo + ((words * (hi - lo)) >> 32)


def _normal(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Box-Muller over two uniforms in (0, 1], in float64, rounded to float32."""
    u1 = 1.0 - streams.uniform(w1).to(torch.float64)
    u2 = streams.uniform(w2).to(torch.float64)
    return (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2 * math.pi * u2)).to(torch.float32)


def _markov(seed: int, step: int, batch: int, seq: int, vocab: int, classes: int, dev):
    """A token stream with low-order structure: token ~ f(prev_class)."""
    steps = _randint(_words(seed, step, _STEPS, (batch, seq), dev), -2, 3)
    cls = torch.remainder(torch.cumsum(steps, dim=1), classes)
    band = max(vocab // classes, 1)
    offs = _randint(_words(seed, step, _OFFSETS, (batch, seq), dev), 0, band)
    return torch.remainder(cls * band + offs, vocab).to(torch.int32)


def make_batch(cfg: ModelConfig, data: DataConfig, step: int, batch: int, seq: int,
               device: str | torch.device = "cuda") -> Dict[str, torch.Tensor]:
    """The global batch of `step` on `device`: {"inputs", "labels"}, labels
    the inputs shifted by one (token families) or drawn (audio)."""
    dev = _device.resolve(device)
    if cfg.family == "audio":
        shape = (batch, seq, cfg.frontend_dim)
        feats = _normal(_words(data.seed, step, _FEATURES, shape, dev),
                        _words(data.seed, step, _FEATURES_2, shape, dev))
        labels = _randint(_words(data.seed, step, _LABELS, (batch, seq), dev), 0,
                          cfg.vocab_size)
        return {"inputs": feats, "labels": labels.to(torch.int32)}
    if data.kind == "random":
        toks = _randint(_words(data.seed, step, _TOKENS, (batch, seq + 1), dev), 0,
                        cfg.vocab_size).to(torch.int32)
    elif data.kind == "lm":
        toks = _markov(data.seed, step, batch, seq + 1, cfg.vocab_size, data.zipf_classes, dev)
    else:
        raise ValueError(f"unknown data kind {data.kind!r}")
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
