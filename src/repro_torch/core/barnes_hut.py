"""Barnes-Hut and direct partner search (port of the single-device part of
`repro/core/barnes_hut.py`): the baselines the paper's FMM replaces.

Barnes-Hut (Rinke et al. 2018) is point-to-area: every neuron descends the
octree from the root on its own, at each level choosing one of the 8
children of its current box with probability proportional to

    w(child) = W_dendrites(child) * K(position, dendrite_centroid(child)),

down to the leaves (acceptance theta = 0), and then draws its partner inside
the chosen leaf from the exact kernel, as the FMM path does
(`traversal.resolve_leaf_partners`).  Direct is the MSP's original O(n^2)
formulation (Eq. 1): one Gumbel-max draw over all n candidates per neuron.
Profiler ranges: `bh.descend` and `traversal.leaf_resolve` (Barnes-Hut),
`direct.find` (direct).

`row_start`/`row_count` restrict the Barnes-Hut search to a rank's neuron
rows (the distributed engine's sharded find phase); the descent needs no
merge across ranks.  The draws name their logical indices (`core.noise`):
neuron row x child for the descent, row x column for the direct draw
(`EngineConfig.rng` selects the noise object).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.profiler import record_function

from repro_torch.core import expansions as ex
from repro_torch.core.noise import sliced
from repro_torch.core.octree import DendriteLevel, OctreeTensors
from repro_torch.core.traversal import FMMConfig, NEG_INF, resolve_leaf_partners


def descend_barnes_hut(tree: OctreeTensors, levels: List[DendriteLevel],
                       positions: torch.Tensor, cfg: FMMConfig, noise, step: int,
                       *, row_start: int = 0, row_count: Optional[int] = None) -> torch.Tensor:
    """Per-neuron stochastic descent of the rows [row_start, row_start +
    row_count) (default: every neuron).  Returns their (row_count,) int64
    target leaf boxes.  A row's choice depends on its own row only, so a
    rank's rows are that slice of the full descent bit for bit."""
    structure = tree.structure
    n = structure.n
    hi = n if row_count is None else row_start + row_count
    dev = positions.device
    arange8 = torch.arange(8, dtype=torch.int64, device=dev)
    rows_all = torch.arange(n, dtype=torch.int64, device=dev)
    pos = positions[row_start:hi]
    box = torch.zeros((hi - row_start,), dtype=torch.int64, device=dev)
    for l in range(structure.depth):
        nxt = levels[l + 1]
        child = (box[:, None] << 3) + arange8[None, :]              # (m, 8)
        den_w = nxt.den_w[child]
        d2 = ((pos[:, None, :] - nxt.den_c[child]) ** 2).sum(dim=-1)
        logw = torch.log(torch.clamp(den_w, min=ex.LOG_EPS)) - d2 / cfg.delta
        logw = torch.where(den_w > 0, logw, NEG_INF)
        g = sliced(noise, lambda r: noise.descent_gumbel(step, l + 1, r), rows_all,
                   row_start, hi)
        box = (box << 3) + torch.argmax(logw + g, dim=-1)           # first max
    return box


def find_partners_bh(tree: OctreeTensors, levels: List[DendriteLevel],
                     positions: torch.Tensor, ax_vac: torch.Tensor,
                     den_vac: torch.Tensor, cfg: FMMConfig, noise, step: int,
                     *, row_start: int = 0, row_count: Optional[int] = None) -> torch.Tensor:
    """Barnes-Hut partner choice: per-neuron descent, then the exact leaf
    resolve, of the rows [row_start, row_start + row_count) (default: every
    neuron).  Returns their int32 partners (-1 = none)."""
    hi = tree.structure.n if row_count is None else row_start + row_count
    with record_function("bh.descend"):
        tgt = descend_barnes_hut(tree, levels, positions, cfg, noise, step,
                                 row_start=row_start, row_count=hi - row_start)
    with record_function("traversal.leaf_resolve"):
        my_tgt = torch.where((ax_vac[row_start:hi] >= 1.0) & (levels[0].den_w[0] > 0), tgt, -1)
        return resolve_leaf_partners(tree, positions, ax_vac, den_vac, my_tgt, cfg,
                                     noise, step, row_start)


def find_partners_direct(positions: torch.Tensor, ax_vac: torch.Tensor,
                         den_vac: torch.Tensor, cfg: FMMConfig, noise, step: int
                         ) -> torch.Tensor:
    """O(n^2) exact partner choice.  Returns (n,) int32 partners (-1 = none).

    The squared distances are summed coordinate by coordinate, in the
    reference's order, so no (n, n, 3) temporary is built."""
    n = positions.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=positions.device)
    with record_function("direct.find"):
        d2 = (positions[:, None, 0] - positions[None, :, 0]) ** 2
        d2 += (positions[:, None, 1] - positions[None, :, 1]) ** 2
        d2 += (positions[:, None, 2] - positions[None, :, 2]) ** 2
        logw = torch.log(torch.clamp(den_vac, min=ex.LOG_EPS))[None, :] - d2 / cfg.delta
        del d2
        mask = (den_vac > 0)[None, :].expand(n, n).clone()
        mask.fill_diagonal_(False)                                  # no autapses
        logw = torch.where(mask, logw, NEG_INF)
        logw += noise.direct_gumbel(step, rows, n)
        partner = torch.argmax(logw, dim=-1).to(torch.int32)
        ok = (ax_vac >= 1.0) & mask.any(dim=-1)
        return torch.where(ok, partner, -1)
