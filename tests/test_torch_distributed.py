"""The distributed engine's helpers in one process (port of the in-process
halves of tests/test_owner_span.py, test_find_sharded.py and
test_routed_exchange.py).

1. `owner_spans` and `routed_tables` equal JAX's field for field for p in
   {1, 2, 4, 8} on uniform, clustered (uneven spans), one-corner (empty
   spans) and depth-1 layouts.
2. p ranks emulated one after another, for p in {2, 4, 8}: the summed
   per-rank pyramid partials, the per-level merged descent maps (direct
   tier too), the row-sliced leaf resolve, the splitter-merged conflict
   resolution and the slot-range insert equal the port's single-device
   functions bit for bit, with batched and counter draws.
3. Per rank, the port's helpers equal JAX's from the same inputs and
   draws: descent partials, leaf rows, accepted counts and committed slot
   ranges bit for bit; raw pyramid partials at rtol 1e-5 plus 1e-5 x the
   field's largest magnitude (mixed-sign Hermite and moment sums).
4. The three static counters equal the JAX engine's integers at p in
   {1, 2, 4, 8, 16}; the engine validates its switches as JAX's does.
5. The group object: a one-rank gloo group through the engine equals the
   single-device run, and the counting wrapper counts; the census; the
   sharding rules; the options carried over from JAX.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from repro.core import octree as joct
from repro.core import synapses as jsyn
from repro.core import traversal as jtrav
from repro.core.distributed import DistributedPlasticityEngine as JaxDistributed
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.msp import MSPConfig as JMSPConfig
from repro_torch import convert
from repro_torch.core import octree, synapses, traversal
from repro_torch.core.distributed import DistributedPlasticityEngine
from repro_torch.core.engine import EngineConfig, PlasticityEngine
from repro_torch.core.msp import MSPConfig
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.streams import CounterNoise
from repro_torch.launch import brain_dryrun, mesh
from repro_torch.sharding import rules

CPU = torch.device("cpu")
DELTA = 750.0 ** 2
CFG = traversal.FMMConfig(c1=8, c2=8)
LEVEL_FIELDS = octree.LevelData._fields


def _t(a):
    return torch.from_numpy(np.array(a))


def _sorted(pos, depth=None, domain=1000.0):
    """Morton-sorted positions and their structure (the engine's layout)."""
    pos = pos[octree.build_structure(pos, domain, depth).order]
    return pos, octree.build_structure(pos, domain, depth)


def _layouts():
    rng = np.random.default_rng(7)
    cluster = rng.normal(80.0, 30.0, (200, 3))
    spread = rng.uniform(0, 1000.0, (56, 3))
    corner = np.array([10.0, 10.0, 10.0]) + rng.uniform(0, 5.0, (64, 3))
    return {
        "uniform": _sorted(np.random.default_rng(3).uniform(0, 1000.0, (256, 3))
                           .astype(np.float32)),
        "clustered": _sorted(np.clip(np.concatenate([cluster, spread]), 0, 999.0)
                             .astype(np.float32), depth=3),
        "corner": _sorted(corner.astype(np.float32), depth=2),
        "depth1": _sorted(np.random.default_rng(5).uniform(0, 1000.0, (64, 3))
                          .astype(np.float32), depth=1),
    }


LAYOUTS = _layouts()


def _vacancies(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3, n).astype(np.float32),
            rng.integers(0, 3, n).astype(np.float32))


# -- 1. spans and routed tables against JAX ----------------------------------------

@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spans_and_routed_tables_equal_jax(layout, p):
    pos, s = LAYOUTS[layout]
    js = joct.build_structure(pos, s.domain, s.depth)
    got, want = octree.owner_spans(s, p), joct.owner_spans(js, p)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, tuple) and b and isinstance(b[0], np.ndarray):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert got.elements_per_device == want.elements_per_device
    assert got.descent_boxes_per_device == want.descent_boxes_per_device
    gt, wt = octree.routed_tables(s, got), joct.routed_tables(js, want)
    assert gt.num_shards == wt.num_shards == p
    for x, y in zip(gt.occ_ids + gt.box_owner, wt.occ_ids + wt.box_owner):
        np.testing.assert_array_equal(x, y)
    if layout == "corner" and p > 1:     # every box on rank 0, empty spans elsewhere
        assert (got.start[:, 1:] == got.stop[:, 1:]).all()
    if layout == "clustered" and p == 4:
        w = got.stop[s.depth] - got.start[s.depth]
        assert w.max() > 2 * w.min() + 1


def test_owner_spans_validation():
    pos, s = LAYOUTS["depth1"]
    with pytest.raises(ValueError, match="divide"):
        octree.owner_spans(s, 3)
    rng = np.random.default_rng(13)
    unsorted = octree.build_structure(rng.uniform(0, 1000.0, (64, 3)).astype(np.float32),
                                      1000.0, 2)
    with pytest.raises(ValueError, match="sorted"):
        octree.owner_spans(unsorted, 2)


# -- 2. emulated ranks against the single-device functions -------------------------

def _emulated_pyramid(tree, p, pos, ax, den, cfg, dendrite_only=False):
    spans = octree.owner_spans(tree.structure, p)
    parts = [octree.build_pyramid_spans(tree, octree.span_layouts(tree, spans, r), pos, ax,
                                        den, cfg.delta, cfg.p, dendrite_only)
             for r in range(p)]
    out = []
    for l in range(tree.structure.depth + 1):
        raw = tuple(sum(fields[1:], start=fields[0]) for fields in zip(*(pr[l] for pr in parts)))
        out.append(octree.finalize_dendrite_level(raw) if dendrite_only
                   else octree.finalize_level(tree.levels[l].centers, raw, cfg.p))
    return out


def _emulated_descend(tree, levels, cfg, noise, p):
    spans = octree.owner_spans(tree.structure, p)
    tgt = traversal._root(levels)
    for level in range(1, tree.structure.depth + 1):
        parts = [traversal.descend_level_partial(tree, spans, r, level, levels[level], tgt, cfg,
                                                 noise, 0) for r in range(p)]
        tgt = sum(parts[1:], start=parts[0]) - 1
    return tgt


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_emulated_pyramid_equals_single_device(layout, p):
    pos, s = LAYOUTS[layout]
    tree = octree.to_device(s, CPU)
    ax, den = (_t(v) for v in _vacancies(s.n))
    want = octree.build_pyramid(tree, _t(pos), ax, den, DELTA)
    for l, (g, w) in enumerate(zip(_emulated_pyramid(tree, p, _t(pos), ax, den, CFG), want)):
        for f in LEVEL_FIELDS:
            assert torch.equal(getattr(g, f), getattr(w, f)), f"p={p} level {l} {f}"
    want = octree.build_dendrite_pyramid(tree, _t(pos), den)
    got = _emulated_pyramid(tree, p, _t(pos), ax, den, CFG, dendrite_only=True)
    for g, w in zip(got, want):
        assert torch.equal(g.den_w, w.den_w) and torch.equal(g.den_c, w.den_c)


@pytest.mark.parametrize("noise", ["batched", "counter"])
@pytest.mark.parametrize("tier", ["paper", "direct"])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_emulated_descent_and_leaf_rows_equal_single_device(p, tier, noise):
    cfg = dataclasses.replace(CFG, tier_mode=tier)
    for layout in ("uniform", "clustered", "corner"):
        pos, s = LAYOUTS[layout]
        tree = octree.to_device(s, CPU)
        ax, den = (_t(v) for v in _vacancies(s.n, seed=2))
        levels = octree.build_pyramid(tree, _t(pos), ax, den, cfg.delta, cfg.p)
        nz = GeneratorNoise(4, CPU) if noise == "batched" else CounterNoise(4, CPU)
        want = traversal.descend(tree, levels, cfg, nz, 0)
        assert torch.equal(_emulated_descend(tree, levels, cfg, nz, p), want), layout
        my_tgt = want[tree.leaf_of]
        full = traversal.resolve_leaf_partners(tree, _t(pos), ax, den, my_tgt, cfg, nz, 0)
        m = s.n // p
        rows = torch.cat([traversal.resolve_leaf_partners(
            tree, _t(pos), ax, den, my_tgt[r * m:(r + 1) * m], cfg, nz, 0, r * m)
            for r in range(p)])
        assert torch.equal(rows, full), layout
        assert int((full >= 0).sum()) > 0


def _emulate_conflicts(partner, req, cap, prio, p, fn):
    """fn(rank, rows, gather) -> accepted, run for every rank: the first
    pass records each rank's gathered runs, the second hands each rank all
    of them; the closing gather of the accepted rows is concatenated."""
    n = partner.shape[0]
    m = n // p
    rows = lambda r: slice(r * m, (r + 1) * m)
    recorded = []
    for r in range(p):
        calls = []
        recorded.append(calls)
        fn(r, rows(r), lambda x, calls=calls: calls.append(x) or x.repeat(p))
    out = []
    for r in range(p):
        k = iter(range(100))
        gather = lambda x: (torch.cat([recorded[q][i] for q in range(p)])
                            if (i := next(k)) < len(recorded[0]) - 1 else x)
        out.append(fn(r, rows(r), gather))
    return out


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_resolve_conflicts_span_equals_resolve_conflicts(seed, p):
    g = torch.Generator().manual_seed(seed)
    n = 64
    partner = torch.where(torch.rand(n, generator=g) < 0.7,
                          torch.randint(0, 12, (n,), generator=g), -1).to(torch.int32)
    req = torch.randint(0, 5, (n,), generator=g, dtype=torch.int32)
    cap = torch.randint(0, 6, (n,), generator=g, dtype=torch.int32)
    # Few distinct priorities: ties across ranks, which the rank order breaks.
    prio = torch.randint(0, 4, (n,), generator=g) << 30
    want = synapses.resolve_conflicts(partner, req, cap, prio)
    got = _emulate_conflicts(partner, req, cap, prio, p, lambda r, rows, gather:
                             synapses.resolve_conflicts_span(partner[rows], req[rows], cap,
                                                             prio[rows], rank=r, gather=gather))
    assert torch.equal(torch.cat(got), want)
    assert 0 < int(want.sum()) < int(req[partner >= 0].sum())     # some requests refused


def _edges(seed, n=64, e=256, fill=0.8):
    rng = np.random.default_rng(seed)
    return (synapses.SynapseState(src=_t(rng.integers(0, n, e).astype(np.int32)),
                                  dst=_t(rng.integers(0, n, e).astype(np.int32)),
                                  valid=_t(rng.random(e) < fill)),
            _t(np.where(rng.random(n) < 0.7, rng.integers(0, n, n), -1).astype(np.int32)),
            rng)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_insert_span_equals_insert(p):
    state, partner, rng = _edges(17)
    k = 4
    accepted = torch.where(partner >= 0, _t(rng.integers(0, k + 1, 64).astype(np.int32)), 0)
    want, dropped = synapses.insert(state, partner, accepted, k)
    assert int(dropped) > 0                                   # the overflow path
    e = state.src.shape[0] // p
    free = (~state.valid).long()
    parts, placed = [], 0
    for r in range(p):
        local = synapses.SynapseState(*(t[r * e:(r + 1) * e] for t in state))
        new, pl, total = synapses.insert_span(local, partner, accepted, k,
                                              free_offset=free[:r * e].sum())
        parts.append(new)
        placed += int(pl)
    for f, w in zip(want._fields, want):
        assert torch.equal(torch.cat([getattr(x, f) for x in parts]), w), f
    assert total - placed == int(dropped)


# -- 3. per rank, the port's helpers against JAX's ------------------------------------

class KeyNoise:
    """The draws the JAX helpers take from `key`, through the port's noise
    interface (whole slabs: the port's batched path cuts its rows)."""

    def __init__(self, key):
        self.key = key

    def descent_gumbel(self, step, level, ids):
        return _t(jax.random.gumbel(jax.random.fold_in(self.key, level), (ids.shape[0], 8),
                                    jnp.float32))

    def leaf_gumbel(self, step, rows, max_leaf):
        return _t(jax.random.gumbel(jax.random.fold_in(self.key, 10_000),
                                    (rows.shape[0], max_leaf), jnp.float32))


def _close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("layout,p", [("uniform", 4), ("clustered", 2)])
def test_rank_helpers_equal_jax(layout, p):
    pos, s = LAYOUTS[layout]
    js = joct.build_structure(pos, s.domain, s.depth)
    tree = octree.to_device(s, CPU)
    ax, den = _vacancies(s.n, seed=3)
    jpos, jax_, jden = jnp.asarray(pos), jnp.asarray(ax), jnp.asarray(den)
    jspans, spans = joct.owner_spans(js, p), octree.owner_spans(s, p)
    # Raw pyramid partials.
    spans_fn = jax.jit(lambda r: joct.build_pyramid_spans(js, jspans, r, jpos, jax_, jden, DELTA))
    for r in range(p):
        want = spans_fn(jnp.int32(r))
        got = octree.build_pyramid_spans(tree, octree.span_layouts(tree, spans, r), _t(pos),
                                         _t(ax), _t(den), DELTA)
        for l, (g, w) in enumerate(zip(got, want)):
            for i, (a, b) in enumerate(zip(g, w)):
                _close(a.numpy(), np.asarray(b), f"rank {r} level {l} field {i}")
    # Descent partials and leaf rows, from JAX's pyramid and draws.
    jlevels = jax.jit(lambda: joct.build_pyramid(js, jpos, jax_, jden, DELTA))()
    levels = [octree.LevelData(*(_t(getattr(lv, f)) for f in LEVEL_FIELDS)) for lv in jlevels]
    key = jax.random.key(11)
    jcfg = jtrav.FMMConfig(c1=8, c2=8)
    jtgt = jax.jit(lambda lv: jtrav.descend(js, lv, key, jcfg))(jlevels)
    tgt_prev = jnp.where((jlevels[0].ax_w > 0) & (jlevels[0].den_w > 0), 0, -1).reshape(1)
    for level in range(1, s.depth + 1):
        fn = jax.jit(lambda r, t, level=level: jtrav.descend_level_partial(
            js, jspans, r, level, jlevels[level], t, key, jcfg))
        wants = [fn(jnp.int32(r), tgt_prev) for r in range(p)]
        for r, want in enumerate(wants):
            got = traversal.descend_level_partial(tree, spans, r, level, levels[level],
                                                  _t(tgt_prev).long(), CFG, KeyNoise(key), 0)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"level {level} rank {r}")
        tgt_prev = sum(wants[1:], start=wants[0]) - 1
    np.testing.assert_array_equal(np.asarray(tgt_prev), np.asarray(jtgt))
    my_tgt = jtgt[jnp.asarray(js.leaf_of)]
    m = s.n // p
    leaf_fn = jax.jit(lambda r0, mt: jtrav.resolve_leaf_partners(js, jpos, jax_, jden, mt, key,
                                                                 jcfg, row_start=r0))
    for r in range(p):
        want = leaf_fn(jnp.int32(r * m), my_tgt[r * m:(r + 1) * m])
        got = traversal.resolve_leaf_partners(tree, _t(pos), _t(ax), _t(den),
                                              _t(my_tgt[r * m:(r + 1) * m]).long(), CFG,
                                              KeyNoise(key), 0, r * m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"rank {r}")


@pytest.mark.parametrize("p", [4])
def test_conflicts_and_insert_per_rank_equal_jax(p):
    state, partner, rng = _edges(5)
    n, k = 64, 4
    req = _t(rng.integers(0, k + 1, n).astype(np.int32))
    cap = _t(rng.integers(0, 6, n).astype(np.int32))
    key = jax.random.key(2)
    prio = _t(np.asarray(jax.random.bits(key, (n,), jnp.uint32))).to(torch.int64)
    got = _emulate_conflicts(partner, req, cap, prio, p, lambda r, rows, gather:
                             synapses.resolve_conflicts_span(partner[rows], req[rows], cap,
                                                             prio[rows], rank=r, gather=gather))
    jp, jr, jc = (jnp.asarray(t.numpy()) for t in (partner, req, cap))
    want = _emulate_conflicts(partner, req, cap, prio, p, lambda r, rows, gather: _t(
        jsyn.resolve_conflicts_span(jp[rows], jr[rows], jc, key, rank=jnp.int32(r),
                                    num_shards=p, gather=lambda x: jnp.asarray(
                                        gather(_t(x)).numpy()))))
    for r, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"rank {r}")
    accepted = torch.cat(got)
    e = state.src.shape[0] // p
    free = (~state.valid).long()
    jstate = jsyn.SynapseState(*(jnp.asarray(t.numpy()) for t in state))
    for r in range(p):
        off = int(free[:r * e].sum())
        local = synapses.SynapseState(*(t[r * e:(r + 1) * e] for t in state))
        new, placed, total = synapses.insert_span(local, partner, accepted, k, free_offset=off)
        jnew, jplaced, jtotal = jsyn.insert_span(
            jsyn.SynapseState(*(x[r * e:(r + 1) * e] for x in jstate)), jp,
            jnp.asarray(accepted.numpy()), k, free_offset=jnp.int32(off))
        for f in new._fields:
            np.testing.assert_array_equal(getattr(new, f).numpy(), np.asarray(getattr(jnew, f)))
        assert int(placed) == int(jplaced) and total == int(jtotal)


# -- 4. counters and validation --------------------------------------------------------

class _FakeMesh:
    def __init__(self, p):
        self.shape = {"data": p}


def _engines(p, method="fmm", n=512, depth=None, **kw):
    pos = np.random.default_rng(0).uniform(0, 1000.0, (n, 3)).astype(np.float32)
    jeng = JaxDistributed(pos, _FakeMesh(p), "data", JMSPConfig.calibrated(speedup=100.0),
                          jtrav.FMMConfig(c1=8, c2=8), JEngineConfig(method=method, depth=depth),
                          **kw)
    eng = DistributedPlasticityEngine(pos, mesh.ShapeGroup(p), MSPConfig.calibrated(speedup=100.0),
                                      CFG, EngineConfig(method=method, depth=depth), device="cpu",
                                      **kw)
    return jeng, eng


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("method", ["fmm", "barnes_hut"])
def test_counters_equal_jax(method, p):
    jeng, eng = _engines(p, method, routed_shared_levels=1)
    np.testing.assert_array_equal(eng.positions_np, jeng.positions_np)
    for mode in ("sharded", "replicated"):
        assert eng.find_phase_work(mode) == jeng.find_phase_work(mode), mode
    for mode in ("gathered", "routed"):
        assert eng.pyramid_exchange_payload(mode) == jeng.pyramid_exchange_payload(mode), mode
    for mode in ("owner_span", "masked"):
        assert (eng.pyramid_elements_per_device(mode)
                == jeng.pyramid_elements_per_device(mode)), mode


def test_switches_are_validated_as_in_jax():
    pos = np.random.default_rng(2).uniform(0, 1000.0, (96, 3)).astype(np.float32)
    make = lambda p=2, method="fmm", **kw: DistributedPlasticityEngine(
        pos, mesh.ShapeGroup(p), engine_cfg=EngineConfig(method=method), device="cpu", **kw)
    for kw, match in ((dict(find_phase="bogus"), "find_phase"),
                      (dict(pyramid_partials="bogus"), "pyramid_partials"),
                      (dict(pyramid_exchange="sparse"), "pyramid_exchange"),
                      (dict(pyramid_exchange="routed", find_phase="replicated"), "routed"),
                      (dict(pyramid_exchange="routed", pyramid_partials="masked"), "routed"),
                      (dict(pyramid_exchange="routed", method="barnes_hut"), "routed"),
                      (dict(method="direct"), "methods"),
                      (dict(p=5), r"shard count \(5\) must divide the neuron")):
        with pytest.raises(ValueError, match=match):
            make(**kw)
    with pytest.raises(ValueError, match="segsum"):
        DistributedPlasticityEngine(pos, mesh.ShapeGroup(2),
                                    engine_cfg=EngineConfig(pyramid="m2m"), device="cpu")
    eng = make(pyramid_exchange="routed", routed_shared_levels=99)
    assert eng.routed_shared_levels == eng.structure.depth
    assert make(routed_shared_levels=-1).routed_shared_levels == 0
    assert make()._tables is None
    with pytest.raises(ValueError, match="exchange"):
        eng.pyramid_exchange_payload("sparse")
    with pytest.raises(RuntimeError, match="no collectives"):
        eng.simulate(eng.init_state(), 1, seed=0)


# -- 5. the group, the census, the rules, the options ------------------------------------

def test_one_rank_gloo_group_runs_the_engine(tmp_path):
    """A one-rank gloo group in this process: 150 steps of the sharded FMM
    engine equal the single-device run bit for bit, and the counting
    wrapper sees 2 collectives per activity step."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        group = mesh.CountingGroup(mesh.Group())
        assert (group.rank, group.size) == (0, 1)
        pos = np.random.default_rng(0).uniform(0, 1000.0, (128, 3)).astype(np.float32)
        msp_cfg = MSPConfig.calibrated(speedup=400.0)
        eng = DistributedPlasticityEngine(pos, group, msp_cfg, CFG, EngineConfig(), device="cpu")
        st, recs = eng.simulate(eng.init_state(), 150, seed=3)
        ref = PlasticityEngine(eng.positions_np, msp_cfg, CFG, EngineConfig(), device="cpu")
        rst, rrecs = ref.simulate(ref.init_state(), 150, seed=3)
        for a, b in zip(recs, rrecs):
            assert torch.equal(a, b)
        for a, b in zip(eng.gather_state(st).edges, rst.edges):
            assert torch.equal(a, b)
        assert int(recs.num_synapses[-1]) > 0
        # A lone step (do_update forced) gathers its spikes and count anew.
        lone, lrec = eng.step(st, GeneratorNoise(3, CPU), do_update=True)
        rlone, rlrec = ref.step(rst, GeneratorNoise(3, CPU), do_update=True)
        for a, b in zip(lrec + eng.gather_state(lone).edges, rlrec + rlone.edges):
            assert torch.equal(a, b)
        c = group.counts
        assert c["gather"]["calls"] >= 150 and c["merge"]["calls"] >= 150
        x = torch.arange(6.0).reshape(1, 2, 3)
        assert torch.equal(mesh.Group().scatter_sum(x), x[0])
        assert torch.equal(mesh.Group().gather(torch.tensor([True, False])),
                           torch.tensor([True, False]))
    finally:
        dist.destroy_process_group()


def test_census_equals_the_jax_counters():
    """The census of the dry-run configuration (U(0, 2000 um)^3, paper
    FMMConfig) at 16 ranks of 64 neurons equals the JAX engine's counters."""
    c = brain_dryrun.run(n_per_rank=64, ranks=16)
    pos = np.random.default_rng(0).uniform(0, 2000.0, (1024, 3)).astype(np.float32)
    jeng = JaxDistributed(pos, _FakeMesh(16), "data", JMSPConfig.calibrated(),
                          jtrav.FMMConfig(), JEngineConfig(method="fmm", domain=2000.0))
    assert (c["neurons"], c["ranks"], c["octree_depth"]) == (1024, 16, jeng.structure.depth)
    for m in ("sharded", "replicated"):
        assert c["find_phase_work"][m] == jeng.find_phase_work(m)
    for m in ("gathered", "routed"):
        assert (c["pyramid_exchange_payload"][m]
                == jeng.pyramid_exchange_payload(m)["pyramid_payload_elements"])
    for m in ("owner_span", "masked"):
        assert c["pyramid_elements_per_device"][m] == jeng.pyramid_elements_per_device(m)
    assert c["pyramid_exchange_payload"]["routed"] < c["pyramid_exchange_payload"]["gathered"]


def test_sharding_rules_and_options_from_jax():
    assert rules.rows_of(2, 4, 16) == (8, 12)
    with pytest.raises(ValueError):
        rules.rows_of(0, 3, 16)
    spec = rules.state_spec()
    assert spec["neurons"] == rules.ROW
    assert spec["edges"] == rules.SLOT and spec["step"] == rules.REPLICATED
    x = torch.arange(8)
    assert torch.equal(rules.shard(rules.ROW, x, 1, 4), x[2:4])
    assert rules.shard(rules.REPLICATED, x, 1, 4) is x
    jeng, _ = _engines(2, pyramid_exchange="routed", routed_shared_levels=1)
    opts = convert.distributed_options_from_jax(
        {k: getattr(jeng, k) for k in convert.DISTRIBUTED_OPTIONS})
    assert opts == dict(pyramid_partials="owner_span", find_phase="sharded",
                        pyramid_exchange="routed", routed_shared_levels=1)
    with pytest.raises(KeyError):
        convert.distributed_options_from_jax({"mesh": None})
