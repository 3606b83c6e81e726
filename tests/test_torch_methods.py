"""The Barnes-Hut and direct search methods of the port against the JAX
package: the partner searches module by module, bit for bit given JAX's
draws, and whole `simulate` runs with `method="barnes_hut"` and
`method="direct"` (N = 256, 300 steps, three connectivity updates, JAX's
draws replayed), held as `tests/test_torch_engine.py` holds the FMM run:
synapse counts, spike rates, edge tables, refractory counters and spikes
exactly; calcium and synaptic elements within rtol 1e-5 (the growth
curve's exp differs by an ulp between torch and XLA:CPU on some inputs).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core import barnes_hut as jbh
from repro.core import engine as jengine
from repro.core import octree as joct
from repro.core import traversal as jtrav
from repro_torch import convert
from repro_torch.core import barnes_hut, engine, octree, traversal
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.streams import CounterNoise

from test_torch_engine import (JaxReplayNoise, MSP_CFG, FMM_CFG, _jax_configs,
                               _jax_state, _mid_growth)

N = 256
STEPS = 300
SEED = 11
METHODS = ["barnes_hut", "direct"]
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs(method):
    jm, jf, je = _jax_configs()
    return (jm, jf, dataclasses.replace(je, method=method)), \
        engine.EngineConfig(method=method)


@pytest.fixture(scope="module", params=METHODS)
def runs(request):
    method = request.param
    pos, arrays = _mid_growth(N, SEED)
    key = jax.random.key(SEED)
    jcfgs, ecfg = _configs(method)
    jst, jrecs = jengine.PlasticityEngine(pos, *jcfgs).simulate(_jax_state(arrays), key,
                                                                STEPS)
    jax.block_until_ready(jrecs.num_synapses)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, ecfg, device="cpu")
    st, recs = eng.simulate(convert.from_jax_state(arrays, "cpu"), STEPS,
                            noise=JaxReplayNoise(key))
    return jst, jrecs, st, recs


def test_records_match_jax_every_step(runs):
    jst, jrecs, st, recs = runs
    np.testing.assert_array_equal(recs.num_synapses.numpy(),
                                  np.asarray(jrecs.num_synapses))
    np.testing.assert_array_equal(recs.spike_rate.numpy(), np.asarray(jrecs.spike_rate))
    np.testing.assert_allclose(recs.calcium_mean.numpy(),
                               np.asarray(jrecs.calcium_mean), rtol=1e-5)
    np.testing.assert_allclose(recs.calcium_std.numpy(),
                               np.asarray(jrecs.calcium_std), rtol=1e-5)


def test_final_state_matches_jax(runs):
    jst, _, st, _ = runs
    got = convert.to_numpy(st)
    for name in ("src", "dst", "valid"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jst.edges, name)),
                                      err_msg=name)
    for name in ("refrac", "spiked"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jst.neurons, name)),
                                      err_msg=name)
    for name in ("calcium", "ax_elems", "den_elems", "x"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(jst.neurons, name)),
                                   rtol=1e-5, err_msg=name)
    assert got["step"] == int(jst.step) == STEPS
    assert got["dropped"] == int(jst.dropped) == 0


def test_run_is_nontrivial(runs):
    """Synapses form at every update, so the equalities are not vacuous."""
    syn = runs[3].num_synapses.numpy()
    assert 0 < syn[99] < syn[199] < syn[299]


# -- the searches module by module ------------------------------------------

def _problem(seed, n=400, domain=1000.0, depth=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, domain, (n, 3)).astype(np.float32)
    ax = rng.integers(0, 3, n).astype(np.float32)
    den = rng.integers(0, 3, n).astype(np.float32)
    js = joct.build_structure(pos, domain, depth)
    jlevels = joct.build_pyramid(js, jnp.asarray(pos), jnp.asarray(ax), jnp.asarray(den),
                                 jtrav.FMMConfig().delta)
    levels = [octree.DendriteLevel(_t(lv.den_w), _t(lv.den_c)) for lv in jlevels]
    tree = octree.to_device(octree.build_structure(pos, domain, depth), CPU)
    return pos, ax, den, js, jlevels, tree, levels


@pytest.mark.parametrize("seed,n,depth", [(0, 400, 3), (1, 1000, 2), (2, 5, 3)])
def test_dendrite_pyramid_equals_the_full_pyramids_dendrite_sums(seed, n, depth):
    """Barnes-Hut's pyramid holds bit for bit the den_w and den_c that the
    FMM's full pyramid holds."""
    rng = np.random.default_rng(seed)
    pos = _t(rng.uniform(0, 1000.0, (n, 3)).astype(np.float32))
    ax = _t(rng.integers(0, 3, n).astype(np.float32))
    den = _t(rng.integers(0, 5, n).astype(np.float32))
    tree = octree.to_device(octree.build_structure(pos.numpy(), 1000.0, depth), CPU)
    full = octree.build_pyramid(tree, pos, ax, den, traversal.FMMConfig().delta)
    got = octree.build_dendrite_pyramid(tree, pos, den)
    assert len(got) == len(full) == depth + 1
    for lv, fl in zip(got, full):
        assert torch.equal(lv.den_w, fl.den_w)
        assert torch.equal(lv.den_c, fl.den_c)


class KeyNoise:
    """The draws of one JAX `find_partners_bh` / `find_partners_direct`
    call from its key, through the port's noise interface."""

    def __init__(self, key):
        self.k1, self.k2 = jax.random.split(key)
        self.key = key

    def descent_gumbel(self, step, level, ids):
        return _t(jax.random.gumbel(jax.random.fold_in(self.k1, level), (ids.shape[0], 8),
                                    jnp.float32))

    def leaf_gumbel(self, step, rows, max_leaf):
        return _t(jax.random.gumbel(jax.random.fold_in(self.k2, 10_000),
                                    (rows.shape[0], max_leaf), jnp.float32))

    def direct_gumbel(self, step, rows, n):
        return _t(jax.random.gumbel(self.key, (rows.shape[0], n), jnp.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_descend_barnes_hut_bit_for_bit(seed):
    pos, _, _, js, jlevels, tree, levels = _problem(seed)
    key = jax.random.key(seed + 5)
    k1, _ = jax.random.split(key)
    want = np.asarray(jbh.descend_barnes_hut(js, jlevels, jnp.asarray(pos), k1,
                                             jtrav.FMMConfig()))
    got = barnes_hut.descend_barnes_hut(tree, levels, _t(pos), traversal.FMMConfig(),
                                        KeyNoise(key), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 50


@pytest.mark.parametrize("seed", [2, 3])
def test_find_partners_bh_bit_for_bit(seed):
    pos, ax, den, js, jlevels, tree, levels = _problem(seed)
    key = jax.random.key(seed)
    want = np.asarray(jbh.find_partners_bh(js, jlevels, jnp.asarray(pos), jnp.asarray(ax),
                                           jnp.asarray(den), key, jtrav.FMMConfig()))
    got = barnes_hut.find_partners_bh(tree, levels, _t(pos), _t(ax), _t(den),
                                      traversal.FMMConfig(), KeyNoise(key), 0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 100


@pytest.mark.parametrize("seed,n", [(0, 256), (1, 300), (2, 7)])
def test_find_partners_direct_bit_for_bit(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1000.0, (n, 3)).astype(np.float32)
    ax = rng.integers(0, 3, n).astype(np.float32)
    den = rng.integers(0, 3, n).astype(np.float32)
    key = jax.random.key(seed)
    want = np.asarray(jbh.find_partners_direct(jnp.asarray(pos), jnp.asarray(ax),
                                               jnp.asarray(den), key, jtrav.FMMConfig()))
    got = barnes_hut.find_partners_direct(_t(pos), _t(ax), _t(den), traversal.FMMConfig(),
                                          KeyNoise(key), 0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > n // 3


def test_direct_with_no_vacant_dendrite_requests_nothing():
    pos = np.random.default_rng(0).uniform(0, 500.0, (16, 3)).astype(np.float32)
    got = barnes_hut.find_partners_direct(_t(pos), torch.full((16,), 2.0),
                                          torch.zeros(16), traversal.FMMConfig(),
                                          GeneratorNoise(0, CPU), 0)
    assert (got == -1).all()


def test_unported_search_options_raise():
    """The sharded find phase's `row_start`/`row_count` (once unported and
    raising) now run on both Barnes-Hut entry points: the rows of 4 ranks,
    concatenated, are the full search bit for bit, with batched and counter
    draws; counter draws run on the full search and the direct draw."""
    pos, ax, den, _, _, tree, levels = _problem(0, n=64, depth=2)
    cfg = traversal.FMMConfig()
    for noise in (GeneratorNoise(0, CPU), CounterNoise(0, CPU)):
        full_box = barnes_hut.descend_barnes_hut(tree, levels, _t(pos), cfg, noise, 0)
        full = barnes_hut.find_partners_bh(tree, levels, _t(pos), _t(ax), _t(den), cfg,
                                           noise, 0)
        rows = [dict(row_start=16 * r, row_count=16) for r in range(4)]
        box = torch.cat([barnes_hut.descend_barnes_hut(tree, levels, _t(pos), cfg, noise, 0,
                                                       **kw) for kw in rows])
        got = torch.cat([barnes_hut.find_partners_bh(tree, levels, _t(pos), _t(ax), _t(den),
                                                     cfg, noise, 0, **kw) for kw in rows])
        assert torch.equal(box, full_box) and torch.equal(got, full)
        assert full.shape == (64,) and bool((full >= -1).all()) and bool((full >= 0).any())
    got = barnes_hut.find_partners_direct(_t(pos), _t(ax), _t(den), cfg, CounterNoise(0, CPU), 0)
    assert got.shape == (64,) and bool((got >= -1).all()) and bool((got >= 0).any())


# -- the engine around them ---------------------------------------------------

@pytest.mark.parametrize("method,present,absent", [
    ("barnes_hut", {"update.pyramid", "bh.descend", "traversal.leaf_resolve"},
     {"direct.find", "traversal.descend"}),
    ("direct", {"direct.find"}, {"update.pyramid", "bh.descend", "traversal.descend"}),
    ("fmm", {"update.pyramid", "traversal.descend", "traversal.leaf_resolve"},
     {"bh.descend", "direct.find"})])
def test_update_runs_in_its_profiler_ranges(method, present, absent):
    pos, arrays = _mid_growth(64, 2)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, engine.EngineConfig(method=method),
                                  device="cpu")
    st = convert.from_jax_state(arrays, "cpu")
    st, _ = eng.simulate(st, 99, seed=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.simulate(st, 1, seed=0)
    names = {e.key for e in prof.key_averages()}
    assert present <= names
    assert not (absent & names)


@pytest.mark.parametrize("method", METHODS)
def test_generator_noise_runs_are_deterministic(method):
    pos, arrays = _mid_growth(64, 3)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, engine.EngineConfig(method=method),
                                  device="cpu")
    st0 = convert.from_jax_state(arrays, "cpu")
    a, ra = eng.simulate(st0, 200, seed=1)
    b, rb = eng.simulate(st0, 200, seed=1)
    for name in ("src", "dst", "valid"):
        assert torch.equal(getattr(a.edges, name), getattr(b.edges, name))
    assert torch.equal(ra.num_synapses, rb.num_synapses)
    assert int(ra.num_synapses[-1]) > 0


@pytest.mark.parametrize("method", ["fmm"] + METHODS)
def test_configs_from_jax_carry_the_method(method):
    jm, jf, je = (dataclasses.asdict(c) for c in _jax_configs())
    got = convert.configs_from_jax(jm, jf, {**je, "method": method})
    assert got[2] == engine.EngineConfig(method=method)
    assert got[2].method == method
