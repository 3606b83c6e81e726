"""The connectivity update of one replica, and whole update intervals.

Frozen copies, simplified to one replica on one device, of
`src/repro_torch/core/synapses.py` (`out_degree`, `in_degree`,
`_sorted_order`, `_segment_starts`, `_rank_within_segment`,
`delete_excess`, `resolve_conflicts`, `_stage_units`, `insert`) and of the
update and step order of `src/repro_torch/core/engine.py`
(`connectivity_update`, `_runtime_sign`) and
`src/repro_torch/core/ensemble.py` (`EnsembleEngine._step`).

An edge table is (src, dst, valid) over a fixed number of slots; a slot's
position matters, since deletion ranks edges by draws keyed by slot.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from bench.reference import neurons as nr
from bench.reference import octree as ot
from bench.reference import search as sr


class Edges(NamedTuple):
    src: torch.Tensor      # (E,) int32
    dst: torch.Tensor      # (E,) int32
    valid: torch.Tensor    # (E,) bool


def degree(ids: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(ids[valid], minlength=n).to(torch.int32)


def sorted_order(seg: torch.Tensor, prio: torch.Tensor) -> torch.Tensor:
    return torch.sort((seg.long() << 32) | prio, stable=True).indices


def segment_starts(sorted_seg: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(sorted_seg, dtype=torch.bool)
    first[1:] = sorted_seg[1:] != sorted_seg[:-1]
    return torch.nonzero(first).squeeze(1)[torch.cumsum(first, dim=0) - 1]


def rank_within_segment(seg_ids, prio, valid) -> torch.Tensor:
    e = seg_ids.shape[0]
    live = torch.nonzero(valid).squeeze(1)
    seg = seg_ids[live]
    order = sorted_order(seg, prio[live])
    idx = torch.arange(live.shape[0], dtype=torch.int64, device=seg_ids.device)
    rank = torch.full((e,), e + 1, dtype=torch.int64, device=seg_ids.device)
    rank[live[order]] = idx - segment_starts(seg[order])
    return rank


def delete_excess(edges: Edges, ax_elems, den_elems, draws, step: int) -> Edges:
    """Each neuron drops (degree - floor(elements)) of its synapses at random
    on each side; a side with no excess draws nothing."""
    n = ax_elems.shape[0]
    e = edges.src.shape[0]
    kill = torch.zeros_like(edges.valid)
    for side, ids, elems in ((0, edges.src, ax_elems), (1, edges.dst, den_elems)):
        excess = torch.clamp(degree(ids, edges.valid, n) - torch.floor(elems).to(torch.int32),
                             min=0)
        if bool((excess > 0).any()):
            rank = rank_within_segment(ids, draws.delete_bits(step, side, e), edges.valid)
            kill |= rank < excess[ids.long()]
    return edges._replace(valid=edges.valid & ~kill)


def resolve_conflicts(partner, request_cnt, den_capacity, prio) -> torch.Tensor:
    """Dendrite-side acceptance in priority order up to each vacancy budget."""
    n = partner.shape[0]
    valid = partner >= 0
    seg = torch.where(valid, partner, n)
    order = sorted_order(seg, prio)
    seg_s = seg[order]
    cnt_s = torch.where(valid[order], request_cnt[order], 0).long()
    cum = torch.cumsum(cnt_s, dim=0) - cnt_s
    before = cum - cum[segment_starts(seg_s)]
    cap = torch.where(seg_s < n, den_capacity[torch.clamp(seg_s, max=n - 1).long()], 0).long()
    acc_s = torch.minimum(torch.clamp(cap - before, min=0), cnt_s)
    accepted = torch.empty_like(acc_s)
    accepted[order] = acc_s
    return torch.where(valid, accepted, 0).to(torch.int32)


def insert(edges: Edges, partner, accepted, max_per_neuron: int):
    """Accepted requests as unit edges into the free slots in slot order.
    Returns (edges, units dropped for want of slots)."""
    n = partner.shape[0]
    k = max_per_neuron
    nk = n * k
    dev = partner.device
    unit = (torch.arange(k, dtype=torch.int32, device=dev)[None, :]
            < accepted[:, None]).reshape(-1)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(k)[unit]
    dst = torch.where(partner >= 0, partner, 0).repeat_interleave(k)[unit]
    total = src.shape[0]
    buf_src = torch.zeros((nk,), dtype=torch.int32, device=dev)
    buf_dst = torch.zeros((nk,), dtype=torch.int32, device=dev)
    buf_src[:total] = src
    buf_dst[:total] = dst
    free = ~edges.valid
    free_rank = torch.cumsum(free, dim=0) - 1
    take = free & (free_rank < total) & (free_rank < nk)
    pick = torch.clamp(free_rank, max=nk - 1)
    out = Edges(src=torch.where(take, buf_src[pick], edges.src),
                dst=torch.where(take, buf_dst[pick], edges.dst), valid=edges.valid | take)
    return out, total - int(take.sum())


class Replica(NamedTuple):
    """What one replica's run is made of."""
    method: str                 # "fmm" | "barnes_hut"
    tree: ot.Tree
    positions: torch.Tensor     # (n, 3) float32
    msp: nr.MSP
    search: sr.Search
    sign: object                # (n,) +1/-1 float32, or None: all excitatory
    max_requests: int


def inhibitory_sign(n: int, fraction: float, device):
    """The first floor(float32(f) * float32(n)) neurons inhibitory."""
    n_inh = np.floor(np.float32(fraction) * np.float32(n))
    if n_inh <= 0:
        return None
    idx = np.arange(n, dtype=np.float32)
    return torch.as_tensor(np.where(idx < n_inh, -1.0, 1.0).astype(np.float32), device=device)


def connectivity_update(rep: Replica, nrn: nr.Neurons, edges: Edges, draws, step: int,
                        dtype) -> tuple:
    """Delete, vacancies, search, conflicts, insert.  Returns (edges, dropped)."""
    n = rep.tree.n
    edges = delete_excess(edges, nrn.ax_elems, nrn.den_elems, draws, step)
    ax_vac = torch.clamp(torch.floor(nrn.ax_elems).to(torch.int32)
                         - degree(edges.src, edges.valid, n), min=0).to(dtype)
    den_vac = torch.clamp(torch.floor(nrn.den_elems).to(torch.int32)
                          - degree(edges.dst, edges.valid, n), min=0).to(dtype)
    partner = sr.find_partners(rep.method, rep.tree, rep.positions.to(dtype), ax_vac, den_vac,
                               rep.search, draws, step)
    req = torch.clamp(ax_vac.to(torch.int32), max=rep.max_requests)
    req = torch.where(partner >= 0, req, 0)
    accepted = resolve_conflicts(partner, req, den_vac.to(torch.int32),
                                 draws.conflict_bits(step, n))
    return insert(edges, partner, accepted, rep.max_requests)


class IntervalResult(NamedTuple):
    neurons: nr.Neurons         # after the interval's last activity step (float32)
    edges: Edges                # after its update
    dropped: int
    records: List[nr.Records]   # one per step


def run_interval(rep: Replica, nrn: nr.Neurons, edges: Edges, draws, step0: int,
                 num_steps: int, dtype=torch.float32) -> IntervalResult:
    """`num_steps` steps from the step counter `step0`: each an activity step,
    followed by the update when the advanced counter is a multiple of the
    update interval (with the draws of the counter before the step)."""
    nrn = nr.cast(nrn, dtype)
    recs, dropped = [], 0
    live = None
    for s in range(step0, step0 + num_steps):
        if live is None:
            slots = torch.nonzero(edges.valid).squeeze(1)
            live = (edges.src[slots].long(), edges.dst[slots].long())
        u = draws.spike_uniform(s, rep.tree.n)
        syn = nr.synaptic_input(*live, nrn.spiked, rep.sign, dtype)
        nrn = nr.step(nrn, syn, u, rep.msp, dtype)
        if (s + 1) % rep.msp.update_interval == 0:
            edges, d = connectivity_update(rep, nrn, edges, draws, s, dtype)
            dropped += d
            live = None
        recs.append(nr.records(nrn, edges.valid.sum(dtype=torch.int32)))
    return IntervalResult(neurons=nr.cast(nrn, torch.float32), edges=edges, dropped=dropped,
                          records=recs)
