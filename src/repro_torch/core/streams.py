"""Counter-mode draws (port of `repro/core/streams.py`; DESIGN.md §14).

`GeneratorNoise` draws a whole array per call, so the value at index i
depends on the array's length.  That breaks the padded-subdomain contract
of the serving layer: a session of n_active neurons in a slot of n_pool
rows must draw, at every active row, what an isolated n_active-row run
draws.  `CounterNoise` makes every draw a pure function of

    (seed, step, draw kind, level, logical index[, column])

so slicing or padding the index set commutes with the draw:
`spike_uniform(s, rows[:m])` is `spike_uniform(s, rows)[:m]` bit for bit.

The hash is stateless and built from plain `torch.int64` operations on
values below 2^32, with every product below 2^63 (`_mul32` splits each
multiplier into 16-bit halves), so there is no signed overflow and the
CPU and the card give the same bits.  It is not threefry: the port accepts
other numbers than the JAX package's from the same seed (ROADMAP.md,
"Random draws"); the tests replay the JAX package's counter draws through
the same interface instead.

Derived values: uniforms take the top 23 bits of a 32-bit word, in [0, 1),
as `jax.random.uniform` does; Gumbels are -log(-log(max(u, tiny))), with
the logarithms taken in float64 and the result rounded to float32, so the
card and the CPU agree on them too; priorities are the 32-bit words,
carried in int64.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import device as _device

_M32 = 0xFFFFFFFF
_TINY = float(torch.finfo(torch.float32).tiny)       # audit: ok (a constant)
# Draw kinds, one word of every key.
SPIKE, DELETE, DESCENT, LEAF, CONFLICT, DIRECT = range(6)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) (an int or an int64 tensor) and a
    constant c in [0, 2^32); c is split into 16-bit halves, so no product
    reaches 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix(x):
    """The `lowbias32` integer finaliser: a bijection of [0, 2^32) in which
    every input bit reaches every output bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _key(seed: int, *words: int) -> tuple:
    """Three 32-bit words keying one draw, hashed on the host from the seed
    (any non-negative int) and the draw's words: an odd multiplier below
    2^31 and two offsets."""
    h = 0x9E3779B9
    for w in (seed & _M32, seed >> 32, *words):
        h = _mix((h + _mix(w & _M32)) & _M32)
    return (_mix(h ^ 1) & 0x7FFFFFFF) | 1, _mix(h ^ 2), _mix(h ^ 3)


def _bits(key, idx: torch.Tensor) -> torch.Tensor:
    """32-bit words, one per index; key is `_key`'s triple (ints, or int64
    tensors that broadcast against idx)."""
    a, b, c = key
    return _mix(_mix((idx * a + b) & _M32) ^ c)


def _bits_grid(key, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(len(rows), len(cols)) words; cell (i, j) depends only on the key,
    rows[i] and cols[j]."""
    a, b, c = key
    return _mix(_bits(key, rows)[:, None] ^ _mix((cols * a + c) & _M32)[None, :])


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from the top 23 of 32 bits (exact)."""
    return (bits >> 9).to(torch.float32) * (1.0 / (1 << 23))


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """-log(-log(max(u, tiny))), computed in float64, rounded to float32."""
    u = uniform(bits).to(torch.float64).clamp_(min=_TINY)
    return (-torch.log(-torch.log(u))).to(torch.float32)


class CounterNoise:
    """The noise interface (`core.noise`) with every draw keyed by its
    logical index.

    seed: any non-negative int (a session's seed).  The index tensors are
    int64 on the device the draws are wanted on."""

    keyed = True    # a draw over a subset of indices is that subset of the draw

    def __init__(self, seed: int, device: str | torch.device = "cuda"):
        if seed < 0:
            raise ValueError(f"seed must be non-negative, got {seed}")
        self.seed = int(seed)
        self.device = _device.resolve(device)

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

    def direct_gumbel(self, step: int, rows: torch.Tensor, n: int) -> torch.Tensor:
        cols = torch.arange(n, dtype=torch.int64, device=rows.device)
        return gumbel(_bits_grid(self.key(DIRECT, step), rows, cols))

    def conflict_bits(self, step: int, rows: torch.Tensor) -> torch.Tensor:
        return _bits(self.key(CONFLICT, step), rows)


def spike_uniforms(noises: Sequence[CounterNoise], steps: Sequence[int],
                   rows: torch.Tensor) -> torch.Tensor:
    """(K, len(rows)) spike uniforms of K counter streams, each at its own
    step, in one pass: row k is `noises[k].spike_uniform(steps[k], rows)`."""
    keys = [nz.key(SPIKE, int(s)) for nz, s in zip(noises, steps)]
    col = lambda i: torch.tensor([k[i] for k in keys], dtype=torch.int64,
                                 device=rows.device)[:, None]
    return uniform(_bits((col(0), col(1), col(2)), rows[None, :]))
