"""The random draws of one replica, derived again from its seed.

Frozen copy of the draw layout of `src/repro_torch/core/noise.py`
(`GeneratorNoise`, the `rng="batched"` source): one `torch.Generator` on
the device, reseeded from (seed, step, draw, index words) through numpy's
`SeedSequence` before every draw.  The reference builds its own object
from the seed the traffic generator hands both sides; it never reads the
program's noise objects.
"""
from __future__ import annotations

import numpy as np
import torch

SPIKE, DELETE, DESCENT, LEAF, CONFLICT = range(5)


class Draws:
    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)

    def _gen_for(self, *words: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, *words]).generate_state(1, np.uint64)[0]
        return self._gen.manual_seed(int(state))

    def _uniform(self, shape, *words: int) -> torch.Tensor:
        return torch.rand(shape, generator=self._gen_for(*words), dtype=torch.float32,
                          device=self.device)

    def _gumbel(self, shape, *words: int) -> torch.Tensor:
        u = self._uniform(shape, *words).clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def _bits(self, shape, *words: int) -> torch.Tensor:
        return torch.randint(0, 1 << 32, shape, generator=self._gen_for(*words),
                             dtype=torch.int64, device=self.device)

    def spike_uniform(self, step: int, n: int) -> torch.Tensor:
        return self._uniform((n,), SPIKE, step)

    def delete_bits(self, step: int, side: int, e: int) -> torch.Tensor:
        return self._bits((e,), DELETE, step, side)

    def descent_gumbel(self, step: int, level: int, rows: int) -> torch.Tensor:
        return self._gumbel((rows, 8), DESCENT, step, level)

    def leaf_gumbel(self, step: int, n: int, max_leaf: int) -> torch.Tensor:
        return self._gumbel((n, max_leaf), LEAF, step)

    def conflict_bits(self, step: int, n: int) -> torch.Tensor:
        return self._bits((n,), CONFLICT, step)
