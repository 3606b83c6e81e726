"""Counter-mode draws of one network, derived again from its seed.

Frozen copy of `src/repro_torch/core/streams.py` (`_mul32`, `_mix`, `_key`,
`_bits`, `_bits_grid`, `uniform`, `gumbel`, `CounterNoise`), the
`rng="counter"` source: every value is a pure function of (seed, step, draw
kind, level, logical index[, column]), so the reference draws any subset
of the indices (a block of rows, a block of slots) alone and gets the
values the whole draw holds there.  The reference builds its own object
from the seed the traffic generator hands both sides; it never reads the
program's noise objects.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_TINY = float(torch.finfo(torch.float32).tiny)
SPIKE, DELETE, DESCENT, LEAF, CONFLICT, DIRECT = range(6)


def _mul32(x, c: int):
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _key(seed: int, *words: int) -> tuple:
    h = 0x9E3779B9
    for w in (seed & _M32, seed >> 32, *words):
        h = _mix((h + _mix(w & _M32)) & _M32)
    return (_mix(h ^ 1) & 0x7FFFFFFF) | 1, _mix(h ^ 2), _mix(h ^ 3)


def _bits(key, idx: torch.Tensor) -> torch.Tensor:
    a, b, c = key
    return _mix(_mix((idx * a + b) & _M32) ^ c)


def _bits_grid(key, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    a, b, c = key
    return _mix(_bits(key, rows)[:, None] ^ _mix((cols * a + c) & _M32)[None, :])


def uniform(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 9).to(torch.float32) * (1.0 / (1 << 23))


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    u = uniform(bits).to(torch.float64).clamp_(min=_TINY)
    return (-torch.log(-torch.log(u))).to(torch.float32)


class CounterDraws:
    """Every draw keyed by its int64 index tensor (rows, slots, box ids)."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def key(self, *words: int) -> tuple:
        return _key(self.seed, *words)

    def spike_uniform(self, step: int, rows: torch.Tensor) -> torch.Tensor:
        return uniform(_bits(self.key(SPIKE, step), rows))

    def delete_bits(self, step: int, side: int, slots: torch.Tensor) -> torch.Tensor:
        return _bits(self.key(DELETE, step, side), slots)

    def descent_gumbel(self, step: int, level: int, ids: torch.Tensor) -> torch.Tensor:
        children = torch.arange(8, dtype=torch.int64, device=ids.device)
        return gumbel(_bits_grid(self.key(DESCENT, step, level), ids, children))

    def leaf_gumbel(self, step: int, rows: torch.Tensor, max_leaf: int) -> torch.Tensor:
        cand = torch.arange(max_leaf, dtype=torch.int64, device=rows.device)
        return gumbel(_bits_grid(self.key(LEAF, step), rows, cand))

    def conflict_bits(self, step: int, rows: torch.Tensor) -> torch.Tensor:
        return _bits(self.key(CONFLICT, step), rows)
