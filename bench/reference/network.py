"""One network too large for the plain reference's whole-array steps,
stepped in blocks: an update interval of the single-device semantics on
the Morton-sorted positions, with counter draws.

The same operations as `neurons.py`, `octree.py`, `search.py` and
`update.py` (frozen copies of the port's plain paths), each cut into
blocks of slots, rows, boxes or segments so that no temporary is more
than a block: spike propagation over the occupied slots in blocks, the
deletion's ranking one block of segments at a time, each pyramid level's
box sums over blocks of boxes (a run wider than a block reduced by its
first halvings column block by column block), the descent over blocks of
source boxes, the leaf resolve over blocks of rows, and the insert's walk
over the free slots in blocks.  Every block computes what the whole-array
operation computes at its elements (element-wise operations, integer
counts, the halving tree's additions in their order), so a blocked run
equals the unblocked one (`bench/tests` holds the two to each other).

The neuron ids are the positions' Morton order, sorted here
(`sorted_tree`, with the octree of the sorted positions: `octree.build_tree`'s
tables, computed on the device), not taken from the program.  The draws
are keyed by index (`streams.CounterDraws`), so a block draws its own rows,
slots or boxes alone.  The octree's tables stay on the host and each
level's come to the device while it is summed.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from bench.reference import neurons as nr
from bench.reference import octree as ot
from bench.reference import search as sr
from bench.reference import update as ur

SLOTS = 1 << 27        # edge slots a block of the table holds
ELEMENTS = 1 << 27     # gathered values a block of the pyramid or the descent holds
ROWS = 1 << 22         # rows of the leaf resolve a block holds


class Net(NamedTuple):
    """The static part of one network's run."""
    tree: ot.Tree              # tables on the host
    positions: torch.Tensor    # (n, 3) float32 on the device, Morton-sorted
    msp: nr.MSP
    search: sr.Search
    max_requests: int


def blocks(total: int, size: int):
    for a in range(0, total, size):
        yield a, min(a + size, total)


# -- the edge table ---------------------------------------------------------------

def live(edges: ur.Edges):
    """(src, dst) int32 of the occupied slots, in slot order."""
    src, dst = [], []
    for a, b in blocks(edges.valid.shape[0], SLOTS):
        v = edges.valid[a:b]
        src.append(edges.src[a:b][v])
        dst.append(edges.dst[a:b][v])
    return torch.cat(src), torch.cat(dst)


def degree(ids: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,), dtype=torch.int64, device=ids.device)
    for a, b in blocks(ids.shape[0], SLOTS):
        out += torch.bincount(ids[a:b][valid[a:b]], minlength=n)
    return out.to(torch.int32)


def count(valid: torch.Tensor) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.int64, device=valid.device)
    for a, b in blocks(valid.shape[0], SLOTS):
        total += valid[a:b].sum()
    return total


def synaptic_input(live_src, live_dst, spiked, dtype) -> torch.Tensor:
    """`neurons.synaptic_input` (all excitatory) over the occupied slots in
    blocks: each adds +1 per spiking partner, an exact integer in float32."""
    n = spiked.shape[0]
    out = torch.zeros((n,), dtype=dtype, device=spiked.device)
    for a, b in blocks(live_src.shape[0], SLOTS):
        s = live_src[a:b].long()
        on = spiked[s]
        d = live_dst[a:b][on].long()
        out.index_add_(0, d, torch.ones(d.shape, dtype=dtype, device=spiked.device))
    return out


def delete_excess(edges: ur.Edges, ax_elems, den_elems, draws, step: int,
                  segments: int = 1 << 24) -> ur.Edges:
    """`update.delete_excess`: each neuron drops (degree - floor(elements))
    of its edges on each side, those first in the order (segment, priority,
    slot).  The ranking runs one block of segments at a time over the live
    slots of neurons with excess (a segment's ranks read only its own
    edges)."""
    n = ax_elems.shape[0]
    valid = edges.valid
    kill = torch.zeros_like(valid)
    for side, ids, elems in ((0, edges.src, ax_elems), (1, edges.dst, den_elems)):
        excess = torch.clamp(degree(ids, valid, n) - torch.floor(elems).to(torch.int32), min=0)
        if not bool((excess > 0).any()):
            continue
        for lo, hi in blocks(n, segments):
            slots = []
            for a, b in blocks(ids.shape[0], SLOTS):
                seg = ids[a:b].long()
                pick = valid[a:b] & (seg >= lo) & (seg < hi)
                pick &= excess[torch.clamp(seg, max=n - 1)] > 0
                slots.append(torch.nonzero(pick).squeeze(1) + a)
            slots = torch.cat(slots)
            seg = ids[slots].long()
            order = torch.sort((seg << 32) | draws.delete_bits(step, side, slots),
                               stable=True).indices
            seg_s = seg[order]
            rank = (torch.arange(slots.shape[0], dtype=torch.int64, device=seg.device)
                    - ur.segment_starts(seg_s))
            kill[slots[order][rank < excess[seg_s]]] = True
    valid &= ~kill                       # in place: the run owns its table
    return edges


def insert(edges: ur.Edges, partner, accepted, max_per_neuron: int):
    """`update.insert`: the accepted units into the free slots in slot
    order, the table walked in blocks until they are placed, in place (the
    run owns its table, which is too large to copy beside itself).
    Returns (edges, units dropped for want of slots)."""
    n = partner.shape[0]
    k = max_per_neuron
    nk = n * k
    dev = partner.device
    unit = (torch.arange(k, dtype=torch.int32, device=dev)[None, :]
            < accepted[:, None]).reshape(-1)
    src_u = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(k)[unit]
    dst_u = torch.where(partner >= 0, partner, 0).repeat_interleave(k)[unit]
    total = src_u.shape[0]
    need = min(total, nk)
    done, placed = 0, 0
    for a, b in blocks(edges.valid.shape[0], SLOTS):
        if done >= need:
            break
        free = ~edges.valid[a:b]
        rank = done + torch.cumsum(free, dim=0) - 1
        at = torch.nonzero(free & (rank < need)).squeeze(1)
        edges.src[a + at] = src_u[rank[at]]
        edges.dst[a + at] = dst_u[rank[at]]
        edges.valid[a + at] = True
        placed += at.shape[0]
        done += int(free.sum())
    return edges, total - placed


# -- the pyramid --------------------------------------------------------------------

def _halve(x, carry):
    while x.shape[1] > 1:
        w = x.shape[1]
        h = w // 2
        if w % 2:
            carry = x[:, w - 1] if carry is None else carry + x[:, w - 1]
        x = x[:, :h] + x[:, h:2 * h]
    return x[:, 0] if carry is None else x[:, 0] + carry


def run_sums(rows_fn, runs: torch.Tensor, channels: int, budget: int = None):
    """`octree.run_sums` of the per-row values `rows_fn(rows)` ((..., C)),
    in blocks of boxes; a run wider than a block is reduced by its first
    halvings column block by column block (column i + h onto column i, as
    the whole tree adds them), then the tree goes on with the carries of
    those halvings in their order."""
    budget = ELEMENTS if budget is None else budget
    boxes, w = runs.shape
    widths = [w]
    while widths[-1] > 1:
        widths.append(widths[-1] // 2)
    k = 0
    while widths[k] * channels > budget and k + 1 < len(widths):
        k += 1
    per = max(1, budget // max(widths[k] * channels, 1))

    def lazy(rr, level, a, b):
        if level == 0:
            return rows_fn(rr[:, a:b])
        h = widths[level]
        return lazy(rr, level - 1, a, b) + lazy(rr, level - 1, a + h, b + h)

    out = []
    for i in range(0, boxes, per):
        rr = runs[i:i + per]
        carry = None
        for level in range(1, k + 1):
            wp = widths[level - 1]
            if wp % 2:
                col = lazy(rr, level - 1, wp - 1, wp)[:, 0]
                carry = col if carry is None else carry + col
        cols = max(1, budget // (4 * rr.shape[0] * channels))
        x = torch.cat([lazy(rr, k, a, min(a + cols, widths[k]))
                       for a in range(0, widths[k], cols)], dim=1)
        out.append(_halve(x, carry))
    return torch.cat(out)


def pyramid(net: Net, ax_vac, den_vac) -> List[ot.LevelSums]:
    """`octree.pyramid` level by level in blocks (the run sums of every
    level, then the centroids and the 1/alpha! of the coefficients)."""
    tree, s = net.tree, net.search
    dev, dt = net.positions.device, net.positions.dtype
    p, k = s.p, s.p ** 3
    on_dev = tree._replace(order=tree.order.to(dev))
    pos_s, ax_s, den_s = (ot.sorted_padded(on_dev, v) for v in (net.positions, ax_vac, den_vac))
    del on_dev
    root = math.sqrt(s.delta)
    fact = torch.as_tensor(ot.multi_factorial(p), dtype=dt, device=dev)
    out = []
    for level in tree.levels:
        centers = level.centers.to(dev).to(dt)
        box_sorted = level.box_sorted.to(dev)

        def rows_fn(rows):
            den, ax, pos = den_s[rows], ax_s[rows], pos_s[rows]
            feats = ot.monomials((pos - centers[box_sorted[rows]]) / root, p)
            return torch.cat([den[..., None], ax[..., None], den[..., None] * pos,
                              ax[..., None] * pos, den[..., None] * feats,
                              ax[..., None] * feats], dim=-1)

        raw = run_sums(rows_fn, level.runs.to(dev), 8 + 2 * k)
        den_w, ax_w = raw[:, 0], raw[:, 1]
        out.append(ot.LevelSums(
            den_w=den_w, ax_w=ax_w,
            den_c=raw[:, 2:5] / torch.clamp(den_w, min=1e-30)[:, None],
            ax_c=raw[:, 5:8] / torch.clamp(ax_w, min=1e-30)[:, None],
            gc=centers, herm=raw[:, 8:8 + k] / fact, moms=raw[:, 8 + k:]))
        del raw, box_sorted
    return out


# -- the search ---------------------------------------------------------------------

def descend(net: Net, levels: List[ot.LevelSums], draws, step: int) -> torch.Tensor:
    """`search.descend_fmm` over blocks of source boxes, each with its own
    boxes' draws (keyed by box id)."""
    tree, s = net.tree, net.search
    dev = net.positions.device
    arange8 = torch.arange(8, dtype=torch.int64, device=dev)
    tgt = torch.where((levels[0].ax_w > 0) & (levels[0].den_w > 0), 0, -1).to(torch.int64)
    per = max(1, ELEMENTS // (8 * s.p ** 3))
    for l in range(1, tree.depth + 1):
        nxt = levels[l]
        occ_all = tree.levels[l].occupied.to(dev)
        valid = tree.box_side(l) <= s.size_guard * math.sqrt(s.guard_delta)
        new = torch.empty_like(occ_all)
        for a, b in blocks(occ_all.shape[0], per):
            occ = occ_all[a:b]
            parent = tgt[occ >> 3]
            base = torch.clamp(parent, min=0)
            tc = (base[:, None] << 3) + arange8[None, :]
            tgt_den_w = nxt.den_w[tc]
            log_mass = sr.tier_log_masses(nxt.ax_w[occ], nxt.ax_c[occ], nxt.gc[occ],
                                          nxt.moms[occ], tgt_den_w, nxt.den_c[tc], nxt.gc[tc],
                                          nxt.herm[tc], s, valid)
            log_mass = torch.where(tgt_den_w > 0, log_mass, sr.NEG_INF)
            choice = torch.argmax(log_mass + draws.descent_gumbel(step, l, occ).to(
                log_mass.dtype), dim=-1)
            alive = (parent >= 0) & (nxt.ax_w[occ] > 0) & (tgt_den_w > 0).any(dim=-1)
            new[a:b] = torch.where(alive, (base << 3) + choice, -1)
        tgt = torch.full((8 ** l,), -1, dtype=torch.int64, device=dev)
        tgt[occ_all] = new
    return tgt


def resolve_leaf(net: Net, ax_vac, den_vac, my_tgt, draws, step: int) -> torch.Tensor:
    """`search.resolve_leaf` over blocks of rows (each row on its own)."""
    tree, s = net.tree, net.search
    n = tree.n
    max_leaf = max(tree.max_leaf, 1)
    dev = net.positions.device
    order, leaf_start = tree.order.to(dev), tree.leaf_start.to(dev)
    slot = torch.arange(max_leaf, dtype=torch.int64, device=dev)[None, :]
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    for a, b in blocks(n, max(1, ROWS // max_leaf)):
        rows = torch.arange(a, b, dtype=torch.int64, device=dev)
        mt = my_tgt[a:b]
        safe = torch.clamp(mt, min=0)
        start = leaf_start[safe]
        cnt = leaf_start[safe + 1] - start
        cand = order[torch.clamp(start[:, None] + slot, max=n - 1)]
        ok = slot < cnt[:, None]
        d2 = ((net.positions[a:b, None, :] - net.positions[cand]) ** 2).sum(dim=-1)
        den_c = den_vac[cand]
        logw = torch.log(torch.clamp(den_c, min=sr.LOG_EPS)) - d2 / s.delta
        mask = ok & (den_c > 0) & (cand != rows[:, None])
        logw = torch.where(mask, logw, sr.NEG_INF)
        pick = torch.argmax(logw + draws.leaf_gumbel(step, rows, max_leaf).to(logw.dtype),
                            dim=-1)
        partner = torch.gather(cand, 1, pick[:, None])[:, 0]
        wants = (ax_vac[a:b] >= 1.0) & (mt >= 0) & mask.any(dim=-1)
        out[a:b] = torch.where(wants, partner, -1).to(torch.int32)
    return out


def connectivity_update(net: Net, nrn: nr.Neurons, edges: ur.Edges, draws, step: int,
                        dtype) -> tuple:
    """Delete, vacancies, search, conflicts, insert (`update.connectivity_update`)."""
    n = net.tree.n
    dev = net.positions.device
    edges = delete_excess(edges, nrn.ax_elems, nrn.den_elems, draws, step)
    ax_vac = torch.clamp(torch.floor(nrn.ax_elems).to(torch.int32)
                         - degree(edges.src, edges.valid, n), min=0).to(dtype)
    den_vac = torch.clamp(torch.floor(nrn.den_elems).to(torch.int32)
                          - degree(edges.dst, edges.valid, n), min=0).to(dtype)
    low = net._replace(positions=net.positions.to(dtype))
    levels = pyramid(low, ax_vac, den_vac)
    leaf_of = net.tree.leaf_of.to(dev)
    tgt = descend(low, levels, draws, step)[leaf_of]
    del levels
    partner = resolve_leaf(low, ax_vac, den_vac, tgt, draws, step)
    req = torch.clamp(ax_vac.to(torch.int32), max=net.max_requests)
    req = torch.where(partner >= 0, req, 0)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    accepted = ur.resolve_conflicts(partner, req, den_vac.to(torch.int32),
                                    draws.conflict_bits(step, rows))
    return insert(edges, partner, accepted, net.max_requests)


def run_interval(net: Net, nrn: nr.Neurons, edges: ur.Edges, draws, step0: int,
                 num_steps: int, dtype=torch.float32) -> ur.IntervalResult:
    """`update.run_interval` in blocks: `num_steps` steps from the step
    counter `step0`, the update after the step whose advanced counter is a
    multiple of the update interval."""
    nrn = nr.cast(nrn, dtype)
    n = net.tree.n
    dev = net.positions.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    recs, dropped, occupied, nsyn = [], 0, None, None
    for s in range(step0, step0 + num_steps):
        if occupied is None:
            occupied = live(edges)
            nsyn = count(edges.valid)
        syn = synaptic_input(*occupied, nrn.spiked, dtype)
        nrn = nr.step(nrn, syn, draws.spike_uniform(s, rows), net.msp, dtype)
        del syn
        if (s + 1) % net.msp.update_interval == 0:
            occupied = None
            edges, d = connectivity_update(net, nrn, edges, draws, s, dtype)
            dropped += d
            nsyn = count(edges.valid)
        recs.append(nr.records(nrn, nsyn))
    return ur.IntervalResult(neurons=nr.cast(nrn, torch.float32), edges=edges,
                             dropped=dropped, records=recs)


def _depth(n: int) -> int:
    """`octree.build_tree`'s automatic depth."""
    return max(1, int(np.ceil(np.log(max(n, 8) / 4.0) / np.log(8.0))))


def morton_codes(positions: np.ndarray, domain: float, device) -> torch.Tensor:
    """(n,) int64 leaf codes of `positions` on `device`, as
    `octree.build_tree` makes them: the cells on the host as there, their
    bits interleaved by a table of `octree._spread_bits` of every cell."""
    positions = np.asarray(positions, np.float32)
    depth = _depth(positions.shape[0])
    cells = np.clip((positions / domain * (2 ** depth)).astype(np.int64), 0, 2 ** depth - 1)
    cells = torch.as_tensor(cells.astype(np.int32), device=device).long()
    spread = torch.as_tensor(ot._spread_bits(np.arange(2 ** depth)).astype(np.int64),
                             device=device)
    return spread[cells[:, 0]] | (spread[cells[:, 1]] << 1) | (spread[cells[:, 2]] << 2)


def _compact(v: torch.Tensor) -> torch.Tensor:
    """`octree._compact_bits` in int64 (every mask is below 2^63)."""
    v = v & 0x1249249249249249
    v = (v ^ (v >> 2)) & 0x10C30C30C30C30C3
    v = (v ^ (v >> 4)) & 0x100F00F00F00F00F
    v = (v ^ (v >> 8)) & 0x1F0000FF0000FF
    v = (v ^ (v >> 16)) & 0x1F00000000FFFF
    return (v ^ (v >> 32)) & 0x1FFFFF


def sorted_tree(positions: np.ndarray, domain: float, device):
    """(the positions in Morton order, ties in their drawn order, and
    `octree.build_tree` of those sorted positions), built on `device` and
    its tables moved to the host.  The sorted positions' codes are the
    drawn ones' in sorted order, so their stable order is the identity and
    each level's tables follow from the leaf offsets alone."""
    positions = np.asarray(positions, np.float32)
    n = positions.shape[0]
    depth = _depth(n)
    codes = morton_codes(positions, domain, device)
    order = torch.sort(codes, stable=True).indices
    codes = codes[order]
    dev = codes.device
    leaf_start = torch.searchsorted(codes, torch.arange(8 ** depth + 1, device=dev))
    host = lambda x: x.to("cpu", torch.int64)
    levels = []
    for l in range(depth + 1):
        starts = leaf_start[::8 ** (depth - l)]
        counts = torch.diff(starts)
        width = max(int(counts.max()), 1)
        slot = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
        runs = torch.where(slot < counts[:, None], starts[:-1, None] + slot, n)
        ids = torch.arange(8 ** l, dtype=torch.int64, device=dev)
        cell = torch.stack([_compact(ids >> d) for d in range(3)], dim=1)
        centers = ((cell.double() + 0.5) * (domain / (2 ** l))).float()
        shift = 3 * (depth - l)
        levels.append(ot.Level(centers=centers.cpu(),
                               occupied=host(torch.nonzero(counts).squeeze(1)),
                               box_sorted=host(torch.cat([codes >> shift, codes.new_zeros(1)])),
                               runs=host(runs)))
        del runs, cell, centers
    tree = ot.Tree(depth=depth, n=n, max_leaf=int(torch.diff(leaf_start).max()) if n else 0,
                   domain=float(domain), order=torch.arange(n, dtype=torch.int64),
                   leaf_start=host(leaf_start), leaf_of=host(codes), levels=levels)
    return torch.as_tensor(positions, device=dev)[order].cpu().numpy(), tree


def build(config: dict, positions: np.ndarray, device, sigma: float, tree=None) -> Net:
    """The network's static part: the octree of the (Morton-sorted)
    positions with its tables on the host (`tree`, or built here), the
    positions on `device`."""
    s = np.float32(sigma)
    search = sr.Search(sigma=s, delta=s ** 2, guard_delta=float(config["sigma"] ** 2),
                       p=int(config["p"]), c1=np.float32(config["c1"]),
                       c2=np.float32(config["c2"]), size_guard=float(config["fmm"]["size_guard"]))
    tree = ot.build_tree(positions, config["domain"], "cpu") if tree is None else tree
    return Net(tree=tree,
               positions=torch.as_tensor(positions, device=device), msp=nr.from_config(config),
               search=search, max_requests=int(config["engine"]["max_requests_per_neuron"]))
