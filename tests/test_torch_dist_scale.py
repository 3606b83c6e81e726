"""What a network of tens of millions of neurons over several cards asks of
the port, at a tiny size on the CPU (no JAX):

* the launcher puts rank r on card r, and refuses before spawning when
  fewer cards than ranks are visible;
* counts that can pass 2^31 are int64: the distributed engine's merged
  synapse count and the records that carry it (gathered over an ensemble
  group too), while the one-card step keeps its int32 count;
* the deletion ranked in place over the slot ranges equals `delete_excess`
  on the whole table (ranks emulated by threads meeting at each gather);
* the blocked paths that bound a level's slab, the descent's gathers, the
  leaf resolve and the slot-range insert give the whole-array bits;
* the host set-up's short cuts give what the per-neuron formulas give:
  the structure of Morton-sorted positions (identity order), the owner
  spans and routed tables from the leaf offsets, the stable sort.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import engine, noise, octree, synapses, traversal
from repro_torch.core.distributed import DistributedPlasticityEngine, sorted_positions
from repro_torch.core.ensemble import EnsembleEngine, gather_records
from repro_torch.core.msp import MSPConfig
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.streams import CounterNoise
from repro_torch.launch import distributed as launch
from repro_torch.launch import mesh

CPU = torch.device("cpu")
MSP_CFG = MSPConfig.calibrated(speedup=400.0)
FMM_CFG = traversal.FMMConfig(c1=8, c2=8)


# -- one card a rank ------------------------------------------------------------------

def test_rank_r_runs_on_card_r():
    assert [launch.rank_device("cuda", r) for r in range(4)] == [f"cuda:{r}" for r in range(4)]
    assert launch.rank_device("cuda:0", 3) == "cuda:3"
    assert launch.rank_device("cpu", 2) == "cpu"


def test_too_few_cards_is_refused_before_spawning(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    import multiprocessing

    def no_spawn(*a, **k):
        raise AssertionError("a rank was spawned")
    monkeypatch.setattr(multiprocessing, "get_context", no_spawn)
    with pytest.raises(RuntimeError, match="4 ranks need 4 cards"):
        launch.run_ranks(4, [], "cuda")


# -- counts past 2^31 -------------------------------------------------------------------

class OffsetGroup(mesh.ShapeGroup):
    """One rank of `size` whose merge adds what the other ranks would: an
    integer tensor gets `offset` added (their counts), a float one zeros;
    a gather repeats this rank's part."""

    def __init__(self, size: int, offset: int):
        super().__init__(size, 0)
        self.offset = offset

    def merge(self, x):
        return x + self.offset if not x.is_floating_point() and x.dtype != torch.bool else x.clone()

    def gather(self, x):
        return torch.cat([x] * self.size)


def test_merged_synapse_count_passes_int32():
    pos = np.random.default_rng(0).uniform(0, 1000.0, (128, 3)).astype(np.float32)
    offset = 3 * 2 ** 30                      # three other ranks of 2^30 synapses
    eng = DistributedPlasticityEngine(pos, OffsetGroup(4, offset), MSP_CFG, FMM_CFG,
                                      engine.EngineConfig(), device="cpu")
    st = eng.init_state()
    st.edges.valid[:5] = True
    _, recs = eng.simulate(st, 3, seed=1)
    assert recs.num_synapses.dtype == torch.int64
    assert recs.num_synapses.tolist() == [offset + 5] * 3
    assert int(recs.num_synapses[0]) > torch.iinfo(torch.int32).max


def test_int64_counts_travel_in_a_records_gather(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        big = torch.tensor([[2 ** 32 + 7, 3], [5, 2 ** 31 + 1]], dtype=torch.int64)
        f = torch.tensor([[0.5, -1.25], [3.0, 1e-30]])
        recs = engine.StepRecord(f, f * 2, big, f + 1)
        got = gather_records(mesh.Group(name="ensemble"), recs)
        for a, b in zip(got, recs):
            assert a.dtype == b.dtype and torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_one_card_step_keeps_its_int32_count():
    pos = np.random.default_rng(1).uniform(0, 1000.0, (64, 3)).astype(np.float32)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, engine.EngineConfig(), device="cpu")
    ens = EnsembleEngine(eng)
    _, recs = ens.simulate(ens.init_states(2), 3, seed=2)
    assert recs.num_synapses.dtype == torch.int32
    _, recs = eng.simulate(eng.init_state(), 3, seed=2)
    assert recs.num_synapses.dtype == torch.int32


def test_keyed_draws_at_slots_past_int32():
    slots = torch.tensor([2 ** 31 + 5, 2 ** 32 - 1, 3], dtype=torch.int64)
    nz = CounterNoise(9, CPU)
    draw = lambda s: nz.delete_bits(4, 1, s)
    assert torch.equal(noise.picked(nz, draw, 2 ** 32, slots), draw(slots))
    small = GeneratorNoise(9, CPU)
    at = torch.tensor([7, 0, 63])
    whole = small.delete_bits(4, 1, torch.arange(64))
    assert torch.equal(noise.picked(small, lambda s: small.delete_bits(4, 1, s), 64, at),
                       whole[at])


# -- the deletion over slot ranges --------------------------------------------------------

class ThreadGather:
    """`Group.gather` for p ranks emulated by p threads of one process: each
    call waits for every rank's part and returns their concatenation."""

    def __init__(self, p: int):
        self.p = p
        self.parts = [None] * p
        self.barrier = threading.Barrier(p)

    def gather(self, rank: int):
        def fn(x):
            self.parts[rank] = x
            self.barrier.wait()
            out = torch.cat(self.parts)
            self.barrier.wait()
            return out
        return fn


def _table(seed: int, n: int = 48, e: int = 1024, live: float = 0.6):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a)
    state = synapses.SynapseState(src=t(rng.integers(0, n, e).astype(np.int32)),
                                  dst=t(rng.integers(0, n, e).astype(np.int32)),
                                  valid=t(rng.random(e) < live))
    # Elements below the degree on many neurons: excess on both sides.
    ax = synapses.out_degree(state, n).float() - t(rng.integers(0, 4, n)).float() + 0.5
    den = synapses.in_degree(state, n).float() - t(rng.integers(0, 3, n)).float() + 0.25
    return state, torch.clamp(ax, min=0), torch.clamp(den, min=0)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("rng", ["counter", "batched"])
def test_deletion_over_slot_ranges_equals_delete_excess(p, rng):
    state, ax, den = _table(p + 10)
    n, e = ax.shape[0], state.valid.shape[0]
    nz = CounterNoise(3, CPU) if rng == "counter" else GeneratorNoise(3, CPU)
    want = synapses.delete_excess(state, ax, den, nz, 11)
    assert int(state.valid.sum() - want.valid.sum()) > 20
    excess = lambda ids, el: torch.clamp(
        synapses._count(ids, state.valid, n) - torch.floor(el).to(torch.int32), min=0)
    ex_src, ex_dst = excess(state.src, ax), excess(state.dst, den)
    per = e // p
    group, got = ThreadGather(p), [None] * p

    def rank(r):
        local = synapses.SynapseState(*(t[r * per:(r + 1) * per] for t in state))
        got[r] = synapses.delete_excess_span(local, ex_src, ex_dst, nz, 11, slot_lo=r * per,
                                             capacity=e, rank=r, gather=group.gather(r))
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(p)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert torch.equal(torch.cat([g.valid for g in got]), want.valid)


def test_deletion_over_slot_ranges_breaks_ties_by_slot():
    """Every priority equal: the global order is the slot order, lower ranks
    first, as the whole table's stable sort has it."""
    class Flat:
        keyed = True

        def delete_bits(self, step, side, slots):
            return torch.zeros_like(slots)
    state, ax, den = _table(5)
    n, e, p = ax.shape[0], state.valid.shape[0], 4
    want = synapses.delete_excess(state, ax, den, Flat(), 0)
    ex = lambda ids, el: torch.clamp(
        synapses._count(ids, state.valid, n) - torch.floor(el).to(torch.int32), min=0)
    group, got, per = ThreadGather(p), [None] * p, e // p

    def rank(r):
        local = synapses.SynapseState(*(t[r * per:(r + 1) * per] for t in state))
        got[r] = synapses.delete_excess_span(local, ex(state.src, ax), ex(state.dst, den),
                                             Flat(), 0, slot_lo=r * per, capacity=e, rank=r,
                                             gather=group.gather(r))
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(p)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert torch.equal(torch.cat([g.valid for g in got]), want.valid)


# -- blocked paths give the whole-array bits -------------------------------------------------

@pytest.mark.parametrize("width,budget", [(37, 40), (64, 64), (1, 8), (200, 90)])
def test_blocked_run_sums_equal_run_sums(width, budget):
    g = torch.Generator().manual_seed(width)
    boxes, rows, ch = 11, 300, 3
    vals = torch.cat([torch.randn(rows, ch, generator=g) * 1e3, torch.zeros(1, ch)])
    runs = torch.randint(0, rows + 1, (boxes, width), generator=g)
    layout = octree.LevelLayout(centers=None, occupied=None, box_sorted=None, runs=runs)
    want = octree._run_sums(vals, layout)
    got = octree._blocked_run_sums(lambda r: vals[r], runs, ch, budget)
    assert torch.equal(got, want)


def _pyramid_engine(n=2048, seed=4):
    pos = np.random.default_rng(seed).uniform(0, 400.0, (n, 3)).astype(np.float32)
    ecfg = engine.EngineConfig(domain=400.0, rng="counter")
    return engine.PlasticityEngine(sorted_positions(pos, ecfg), MSP_CFG,
                                   traversal.FMMConfig(sigma=300.0, c1=8, c2=8), ecfg,
                                   device="cpu")


def test_blocked_level_sums_equal_the_whole_slab(monkeypatch):
    eng = _pyramid_engine()
    g = torch.Generator().manual_seed(1)
    ax, den = (torch.floor(torch.rand(eng.n, generator=g) * 5) for _ in range(2))
    want = octree.build_pyramid(eng.tree, eng.positions, ax, den, 300.0 ** 2, 4)
    monkeypatch.setattr(octree, "SLAB_ELEMENTS", 4096)
    got = octree.build_pyramid(eng.tree, eng.positions, ax, den, 300.0 ** 2, 4)
    for lw, lg in zip(want, got):
        for a, b in zip(lw, lg):
            assert torch.equal(a, b)


def test_blocked_descent_and_resolve_equal_the_whole_slabs(monkeypatch):
    eng = _pyramid_engine()
    g = torch.Generator().manual_seed(2)
    ax, den = (torch.floor(torch.rand(eng.n, generator=g) * 5) for _ in range(2))
    nz = CounterNoise(5, CPU)
    cfg = eng.fmm_cfg
    levels = octree.build_pyramid(eng.tree, eng.positions, ax, den, cfg.delta, cfg.p)
    want = traversal.find_partners(eng.tree, levels, eng.positions, ax, den, cfg, nz, 7)
    assert int((want >= 0).sum()) > 100
    monkeypatch.setattr(traversal, "SCORE_BOXES", 5)
    monkeypatch.setattr(traversal, "RESOLVE_SLOTS", 97)
    got = traversal.find_partners(eng.tree, levels, eng.positions, ax, den, cfg, nz, 7)
    assert torch.equal(got, want)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_insert_span_in_blocks_equals_insert(monkeypatch, p):
    rng = np.random.default_rng(p)
    n, e, k = 64, 512, 4
    t = lambda a: torch.as_tensor(a)
    state = synapses.SynapseState(src=t(rng.integers(0, n, e).astype(np.int32)),
                                  dst=t(rng.integers(0, n, e).astype(np.int32)),
                                  valid=t(rng.random(e) < 0.8))
    partner = t(np.where(rng.random(n) < 0.7, rng.integers(0, n, n), -1).astype(np.int32))
    accepted = torch.where(partner >= 0, t(rng.integers(0, k + 1, n).astype(np.int32)), 0)
    want, dropped = synapses.insert(state, partner, accepted, k)
    monkeypatch.setattr(synapses, "INSERT_BLOCK", 24)
    per, free = e // p, (~state.valid).long()
    parts, placed = [], 0
    for r in range(p):
        local = synapses.SynapseState(*(x[r * per:(r + 1) * per] for x in state))
        new, pl, total = synapses.insert_span(local, partner, accepted, k,
                                              free_offset=free[:r * per].sum())
        parts.append(new)
        placed += int(pl)
    for f, w in zip(want._fields, want):
        assert torch.equal(torch.cat([getattr(x, f) for x in parts]), w), f
    assert total - placed == int(dropped)


# -- the host set-up ----------------------------------------------------------------------

def _per_neuron_spans(structure, p):
    """Owner spans by the per-neuron formulas: each neuron's box's first
    member, its rank, and the searches over every neuron."""
    n_local, ranks = structure.n // p, np.arange(p)
    out = []
    for level in range(structure.depth + 1):
        ids = structure.box_of(level)
        first = np.r_[True, ids[1:] != ids[:-1]]
        first_idx = np.maximum.accumulate(np.where(first, np.arange(ids.shape[0]), 0))
        owner = (first_idx // n_local).astype(np.int32)
        occ_owner = owner[np.flatnonzero(first)]
        out.append((owner, np.searchsorted(owner, ranks, "left"),
                    np.searchsorted(owner, ranks, "right"),
                    np.searchsorted(occ_owner, ranks, "left"),
                    np.searchsorted(occ_owner, ranks, "right"), occ_owner))
    return out


@pytest.mark.parametrize("n,depth,clustered", [(96, 2, False), (4096, 4, True),
                                               (12000, 3, False), (8, 1, False)])
def test_host_setup_short_cuts_equal_the_per_neuron_formulas(n, depth, clustered):
    rng = np.random.default_rng(n + depth)
    pos = (rng.normal(500, 90, (n, 3)).clip(0, 999) if clustered
           else rng.uniform(0, 1000, (n, 3))).astype(np.float32)
    s = octree.build_structure(pos, 1000.0, depth)
    assert np.array_equal(s.order, np.argsort(s.codes, kind="stable"))
    assert np.array_equal(s.inv_order[s.order], np.arange(n))
    ps = pos[s.order]
    assert np.array_equal(sorted_positions(pos, engine.EngineConfig(domain=1000.0, depth=depth)),
                          ps)
    t = octree.build_structure(ps, 1000.0, depth)
    assert np.array_equal(t.order, np.arange(n)) and np.array_equal(t.inv_order, np.arange(n))
    assert np.array_equal(t.codes, s.codes[s.order]) and np.array_equal(t.leaf_start, s.leaf_start)
    for p in (1, 2, 4, 8):
        spans = octree.owner_spans(t, p)
        tables = octree.routed_tables(t, spans)
        for level, (owner, lo, hi, olo, ohi, occ_owner) in enumerate(_per_neuron_spans(t, p)):
            assert np.array_equal(spans.neuron_owner[level], owner)
            assert spans.neuron_owner[level].dtype == np.int32
            assert np.array_equal(spans.start[level], lo) and np.array_equal(spans.stop[level], hi)
            assert np.array_equal(spans.occ_start[level], olo)
            assert np.array_equal(spans.occ_stop[level], ohi)
            dense = tables.box_owner[level]
            assert np.array_equal(dense[t.occupied_at(level)], occ_owner)
            assert int((dense >= 0).sum()) == occ_owner.shape[0]
    backwards = octree.build_structure(ps[::-1].copy(), 1000.0, depth)
    assert np.any(backwards.codes[1:] < backwards.codes[:-1])
    with pytest.raises(ValueError, match="Morton-sorted"):
        octree.owner_spans(backwards, 2)
    with pytest.raises(ValueError, match="Morton-sorted"):
        octree.routed_tables(backwards, octree.owner_spans(t, 2))
