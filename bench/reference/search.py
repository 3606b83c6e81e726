"""The partner search of one connectivity update, in plain PyTorch.

Frozen copies, simplified to one device, of:
  * `src/repro_torch/core/traversal.py`: the tiered box masses of Alg. 2
    (`_tier_log_masses`), the level-synchronous FMM descent (`_score_level`,
    `_root`, `descend`) and the leaf resolve (`resolve_leaf_partners`);
  * `src/repro_torch/core/expansions.py`: the log-factored box masses
    (`box_mass_direct_log`, `box_mass_hermite_log`, `box_mass_taylor_log`);
  * `src/repro_torch/kernels/m2l_pair.py`: `m2l_separable_plain`, the plain
    version of the `m2l_separable` CUDA kernel;
  * `src/repro_torch/core/barnes_hut.py`: the per-neuron Barnes-Hut descent
    (`descend_barnes_hut`, `find_partners_bh`).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from bench.reference import octree as ot

NEG_INF = -1e30
LOG_EPS = 1e-30


class Search(NamedTuple):
    """The knobs of one replica's search (its `KernelParams` row applied to
    the engine's static FMM configuration)."""
    sigma: np.float32
    delta: np.float32          # float32(sigma)^2, rounded in float32
    guard_delta: float         # the static sigma's delta: the expansions' guard
    p: int
    c1: np.float32
    c2: np.float32
    size_guard: float


def m2l_separable(moms, herm, y, p: int):
    """sum_{a,b} sign_a A_a (M_b / b!) prod_d H_{a_d + b_d}(y_d):  (B, p^3),
    (B, p^3), (B, 3) -> (B,)."""
    hd = ot.hermite_polys_1d(y, 2 * p - 1)
    a = np.arange(p)
    g = hd[..., torch.as_tensor(a[:, None] + a[None, :], device=y.device)]
    dev, dt = moms.device, moms.dtype
    sign = torch.as_tensor(ot.sign_table(p), dtype=dt, device=dev)
    fact = torch.as_tensor(ot.multi_factorial(p), dtype=dt, device=dev)
    t = (moms / fact).reshape(moms.shape[:-1] + (p, p, p))
    t = torch.einsum('...ab,...bcd->...acd', g[..., 0, :, :], t)
    t = torch.einsum('...ab,...cbd->...cad', g[..., 1, :, :], t)
    t = torch.einsum('...ab,...cdb->...cda', g[..., 2, :, :], t)
    asign = (herm * sign).reshape(herm.shape[:-1] + (p, p, p))
    return (asign * t).sum(dim=(-3, -2, -1))


def mass_direct_log(ax_w, ax_c, den_w, den_c, delta):
    d2 = ((ax_c - den_c) ** 2).sum(dim=-1)
    return (torch.log(torch.clamp(ax_w, min=LOG_EPS))
            + torch.log(torch.clamp(den_w, min=LOG_EPS)) - d2 / delta)


def mass_taylor_log(moms, ax_c, herm, den_c, delta, p: int):
    y = (den_c - ax_c) / math.sqrt(delta)
    k = moms.shape[-1]
    batch = torch.broadcast_shapes(moms.shape[:-1], herm.shape[:-1], y.shape[:-1])
    flat = lambda a, d: a.expand(batch + (d,)).reshape(-1, d).contiguous()
    series = m2l_separable(flat(moms, k), flat(herm, k), flat(y, 3), p).reshape(batch)
    yb = y.expand(batch + (3,))
    return -(yb * yb).sum(dim=-1) + torch.log(torch.clamp(series, min=LOG_EPS))


def mass_hermite_log(ax_w, ax_c, herm, den_c, delta, p: int):
    e0 = torch.zeros((p ** 3,), dtype=herm.dtype, device=herm.device)
    e0[0] = 1.0
    return (torch.log(torch.clamp(ax_w, min=LOG_EPS))
            + mass_taylor_log(e0, ax_c, herm, den_c, delta, p))


def tier_log_masses(src_ax_w, src_ax_c, src_gc, src_moms, tgt_den_w, tgt_den_c, tgt_gc,
                    tgt_herm, s: Search, expansions_valid: bool):
    """The three tiers of Alg. 2 blended into one (B, 8) log-mass slab."""
    ax_w = src_ax_w[:, None]
    ax_c = src_ax_c[:, None, :]
    log_direct = mass_direct_log(ax_w, ax_c, tgt_den_w, tgt_den_c, s.delta)
    if not expansions_valid:
        return log_direct
    log_hermite = mass_hermite_log(ax_w, ax_c, tgt_herm, tgt_gc, s.delta, s.p)
    log_taylor = mass_taylor_log(src_moms[:, None, :], src_gc[:, None, :], tgt_herm, tgt_gc,
                                 s.delta, s.p)
    heavy_den = tgt_den_w > s.c1
    heavy_ax = (src_ax_w > s.c2)[:, None]
    return torch.where(heavy_den & heavy_ax, log_hermite,
                       torch.where(heavy_den, log_taylor, log_direct))


def descend_fmm(tree: ot.Tree, levels: List[ot.LevelSums], s: Search, draws,
                step: int) -> torch.Tensor:
    """(8^depth,) target leaf of every source leaf box (-1: none)."""
    dev = tree.order.device
    arange8 = torch.arange(8, dtype=torch.int64, device=dev)
    tgt = torch.where((levels[0].ax_w > 0) & (levels[0].den_w > 0), 0, -1).to(torch.int64)
    for l in range(1, tree.depth + 1):
        nxt = levels[l]
        occ = tree.levels[l].occupied
        parent = tgt[occ >> 3]
        base = torch.clamp(parent, min=0)
        tc = (base[:, None] << 3) + arange8[None, :]
        valid = tree.box_side(l) <= s.size_guard * math.sqrt(s.guard_delta)
        tgt_den_w = nxt.den_w[tc]
        log_mass = tier_log_masses(nxt.ax_w[occ], nxt.ax_c[occ], nxt.gc[occ], nxt.moms[occ],
                                   tgt_den_w, nxt.den_c[tc], nxt.gc[tc], nxt.herm[tc], s,
                                   valid)
        log_mass = torch.where(tgt_den_w > 0, log_mass, NEG_INF)
        gumbel = draws.descent_gumbel(step, l, occ.shape[0]).to(log_mass.dtype)
        choice = torch.argmax(log_mass + gumbel, dim=-1)
        alive = (parent >= 0) & (nxt.ax_w[occ] > 0) & (tgt_den_w > 0).any(dim=-1)
        new = torch.where(alive, (base << 3) + choice, -1)
        tgt = torch.full((8 ** l,), -1, dtype=torch.int64, device=dev)
        tgt[occ] = new
    return tgt


def descend_bh(tree: ot.Tree, levels: List[ot.DendriteSums], positions, s: Search, draws,
               step: int) -> torch.Tensor:
    """(n,) target leaf of every neuron, each descending on its own."""
    n = tree.n
    dev = positions.device
    arange8 = torch.arange(8, dtype=torch.int64, device=dev)
    box = torch.zeros((n,), dtype=torch.int64, device=dev)
    for l in range(tree.depth):
        nxt = levels[l + 1]
        child = (box[:, None] << 3) + arange8[None, :]
        den_w = nxt.den_w[child]
        d2 = ((positions[:, None, :] - nxt.den_c[child]) ** 2).sum(dim=-1)
        logw = torch.log(torch.clamp(den_w, min=LOG_EPS)) - d2 / s.delta
        logw = torch.where(den_w > 0, logw, NEG_INF)
        g = draws.descent_gumbel(step, l + 1, n).to(logw.dtype)
        box = (box << 3) + torch.argmax(logw + g, dim=-1)
    return box


def resolve_leaf(tree: ot.Tree, positions, ax_vac, den_vac, my_tgt, s: Search, draws,
                 step: int) -> torch.Tensor:
    """One exact categorical draw per requesting neuron over its target
    leaf's neurons.  (n,) int32 partner (-1: none)."""
    n = tree.n
    max_leaf = max(tree.max_leaf, 1)
    dev = positions.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    safe = torch.clamp(my_tgt, min=0)
    start = tree.leaf_start[safe]
    count = tree.leaf_start[safe + 1] - start
    slot = torch.arange(max_leaf, dtype=torch.int64, device=dev)[None, :]
    cand = tree.order[torch.clamp(start[:, None] + slot, max=n - 1)]
    valid = slot < count[:, None]
    d2 = ((positions[:, None, :] - positions[cand]) ** 2).sum(dim=-1)
    den_c = den_vac[cand]
    logw = torch.log(torch.clamp(den_c, min=LOG_EPS)) - d2 / s.delta
    mask = valid & (den_c > 0) & (cand != rows[:, None])
    logw = torch.where(mask, logw, NEG_INF)
    gumbel = draws.leaf_gumbel(step, n, max_leaf).to(logw.dtype)
    pick = torch.argmax(logw + gumbel, dim=-1)
    partner = torch.gather(cand, 1, pick[:, None])[:, 0]
    wants = (ax_vac >= 1.0) & (my_tgt >= 0) & mask.any(dim=-1)
    return torch.where(wants, partner, -1).to(torch.int32)


def find_partners(method: str, tree: ot.Tree, positions, ax_vac, den_vac, s: Search, draws,
                  step: int) -> torch.Tensor:
    """(n,) int32 partner request of every neuron (-1: none)."""
    if method == "fmm":
        levels = ot.pyramid(tree, positions, ax_vac, den_vac, s.delta, s.p)
        tgt = descend_fmm(tree, levels, s, draws, step)[tree.leaf_of]
    elif method == "barnes_hut":
        levels = ot.dendrite_pyramid(tree, positions, den_vac)
        tgt = descend_bh(tree, levels, positions, s, draws, step)
        tgt = torch.where((ax_vac >= 1.0) & (levels[0].den_w[0] > 0), tgt, -1)
    else:
        raise ValueError(f"the reference has no search method {method!r}")
    return resolve_leaf(tree, positions, ax_vac, den_vac, tgt, s, draws, step)
