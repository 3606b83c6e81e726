"""The port's modules one by one against their JAX counterparts.

Integer and layout outputs (octree structure, descent targets, partners,
ranks, acceptance, slot placement) must match bit for bit given the same
random draws; float sums are checked at tolerance, each stated below.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import expansions as jex
from repro.core import multi_index as jmi
from repro.core import octree as joct
from repro.core import synapses as jsyn
from repro.core import traversal as jtrav
from repro_torch.core import expansions as ex
from repro_torch.core import multi_index as mi
from repro_torch.core import octree, synapses, traversal

DELTA = 750.0 ** 2
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a)


class SlabNoise:
    """Hands out given draws through the port's noise interface."""

    def __init__(self, **slabs):
        self.slabs = slabs

    def descent_gumbel(self, step, level, ids):
        return self.slabs["descent"][level]

    def leaf_gumbel(self, step, rows, max_leaf):
        return self.slabs["leaf"]

    def delete_bits(self, step, side, slots):
        return self.slabs["delete"][side]


def _setup(seed=0, n=400, domain=1000.0, depth=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, domain, (n, 3)).astype(np.float32)
    ax = rng.integers(0, 3, n).astype(np.float32)
    den = rng.integers(0, 3, n).astype(np.float32)
    return pos, ax, den, depth, domain


def _descent_gumbels(key, structure):
    return {l: _t(jax.random.gumbel(jax.random.fold_in(key, l),
                                    (structure.occupied_at(l).shape[0], 8),
                                    jnp.float32))
            for l in range(1, structure.depth + 1)}


def _port_levels(jlevels):
    return [octree.LevelData(*(_t(getattr(lv, f)) for f in octree.LevelData._fields))
            for lv in jlevels]


@pytest.mark.parametrize("seed,n,depth", [(0, 200, 3), (1, 1000, None), (2, 37, 2)])
def test_build_structure_bit_for_bit(seed, n, depth):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1500.0, (n, 3)).astype(np.float32)
    want = joct.build_structure(pos, 1500.0, depth)
    got = octree.build_structure(pos, 1500.0, depth)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name),
                                      err_msg=f.name)
    for l in range(want.depth + 1):
        np.testing.assert_array_equal(got.centers_at(l), want.centers_at(l))
        np.testing.assert_array_equal(got.occupied_at(l), want.occupied_at(l))


def test_build_pyramid_matches_jax():
    """Level sums: rtol 1e-5, plus an absolute floor of 1e-5 x the field's
    largest magnitude — the Hermite and moment sums mix signs, so a
    near-cancelled entry carries the rounding of its largest terms."""
    pos, ax, den, depth, domain = _setup(0)
    js = joct.build_structure(pos, domain, depth)
    want = joct.build_pyramid(js, jnp.asarray(pos), jnp.asarray(ax), jnp.asarray(den),
                              DELTA)
    tree = octree.to_device(octree.build_structure(pos, domain, depth), CPU)
    got = octree.build_pyramid(tree, _t(pos), _t(ax), _t(den), DELTA)
    assert len(got) == len(want) == depth + 1
    for g, w in zip(got, want):
        for f in octree.LevelData._fields:
            a, b = getattr(g, f).numpy(), _np(getattr(w, f))
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * max(np.abs(b).max(), 1e-30),
                                       err_msg=f)


def test_build_pyramid_is_deterministic_and_conserves_mass():
    pos, ax, den, depth, domain = _setup(5)
    tree = octree.to_device(octree.build_structure(pos, domain, depth), CPU)
    a = octree.build_pyramid(tree, _t(pos), _t(ax), _t(den), DELTA)
    b = octree.build_pyramid(tree, _t(pos), _t(ax), _t(den), DELTA)
    for la, lb in zip(a, b):
        for f in octree.LevelData._fields:
            assert torch.equal(getattr(la, f), getattr(lb, f))
        assert float(la.ax_w.sum()) == float(ax.sum())
        assert float(la.den_w.sum()) == float(den.sum())


def test_monomials_and_hermite_polys_match_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.5, 1.5, (50, 3)).astype(np.float32)
    np.testing.assert_array_equal(mi.monomials(_t(x)).numpy(),
                                  _np(jmi.monomials(jnp.asarray(x))))
    np.testing.assert_allclose(mi._per_dim_hermite_poly(_t(x), 7).numpy(),
                               _np(jmi._per_dim_hermite_poly(jnp.asarray(x), 7)),
                               rtol=1e-6, atol=1e-6)
    for table in ("multi_factorial", "sign_table", "multi_indices"):
        np.testing.assert_array_equal(getattr(mi, table)(), getattr(jmi, table)())


def _mass_inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        count=rng.integers(0, 20, (9, 1)).astype(np.float32),
        weight=rng.integers(0, 20, (9, 8)).astype(np.float32),
        moms=rng.uniform(0, 1, (9, 8, 64)).astype(np.float32),
        herm=rng.uniform(-1, 1, (9, 8, 64)).astype(np.float32),
        axc=rng.uniform(0, 2000, (9, 1, 3)).astype(np.float32),
        dc=rng.uniform(0, 2000, (9, 8, 3)).astype(np.float32))


def test_box_mass_logs_match_jax():
    """tests/test_expansions.py tolerances: rtol 1e-3 / atol 1e-3 for the
    M2L series, rtol 1e-4 for the Hermite evaluation; the direct tier is a
    few float ops, held at rtol 1e-6."""
    d = _mass_inputs(3)
    J = {k: jnp.asarray(v) for k, v in d.items()}
    T = {k: _t(v) for k, v in d.items()}
    np.testing.assert_allclose(
        ex.box_mass_direct_log(T["count"], T["axc"], T["weight"], T["dc"], DELTA).numpy(),
        _np(jex.box_mass_direct_log(J["count"], J["axc"], J["weight"], J["dc"], DELTA)),
        rtol=1e-6)
    np.testing.assert_allclose(
        ex.box_mass_taylor_log(T["moms"], T["axc"], T["herm"], T["dc"], DELTA).numpy(),
        _np(jex.box_mass_taylor_log(J["moms"], J["axc"], J["herm"], J["dc"], DELTA)),
        rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        ex.box_mass_hermite_log(T["count"], T["axc"], T["herm"], T["dc"], DELTA).numpy(),
        _np(jex.box_mass_hermite_log(J["count"], J["axc"], J["herm"], J["dc"], DELTA)),
        rtol=1e-4)


@pytest.mark.parametrize("tier", ["paper", "direct", "hermite", "taylor"])
def test_descend_targets_bit_for_bit(tier):
    """Given the reference's pyramid and Gumbel slabs, the port's descent
    chooses the same target leaf for every source leaf."""
    pos, ax, den, depth, domain = _setup(1)
    js = joct.build_structure(pos, domain, depth)
    jcfg = jtrav.FMMConfig(tier_mode=tier, c1=4, c2=4)
    jlevels = joct.build_pyramid(js, jnp.asarray(pos), jnp.asarray(ax),
                                 jnp.asarray(den), jcfg.delta)
    key = jax.random.key(7)
    want = _np(jtrav.descend(js, jlevels, key, jcfg))
    tree = octree.to_device(octree.build_structure(pos, domain, depth), CPU)
    cfg = traversal.FMMConfig(tier_mode=tier, c1=4, c2=4)
    got = traversal.descend(tree, _port_levels(jlevels), cfg,
                            SlabNoise(descent=_descent_gumbels(key, js)), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 10


def test_find_partners_bit_for_bit():
    """The descent and the leaf resolve together (`find_partners`), with
    the reference's pyramid and draws."""
    pos, ax, den, depth, domain = _setup(2)
    js = joct.build_structure(pos, domain, depth)
    jcfg = jtrav.FMMConfig(c1=4, c2=4)
    jlevels = joct.build_pyramid(js, jnp.asarray(pos), jnp.asarray(ax),
                                 jnp.asarray(den), jcfg.delta)
    key = jax.random.key(3)
    want = _np(jtrav.find_partners(js, jlevels, jnp.asarray(pos), jnp.asarray(ax),
                                   jnp.asarray(den), key, jcfg))
    k1, k2 = jax.random.split(key)
    leaf = _t(jax.random.gumbel(jax.random.fold_in(k2, 10_000),
                                (js.n, js.max_leaf), jnp.float32))
    tree = octree.to_device(octree.build_structure(pos, domain, depth), CPU)
    got = traversal.find_partners(
        tree, _port_levels(jlevels), _t(pos), _t(ax), _t(den),
        traversal.FMMConfig(c1=4, c2=4),
        SlabNoise(descent=_descent_gumbels(k1, js), leaf=leaf), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 50


def test_resolve_leaf_partners_bit_for_bit():
    pos, ax, den, depth, domain = _setup(4)
    js = joct.build_structure(pos, domain, depth)
    rng = np.random.default_rng(9)
    my_tgt = rng.integers(-1, js.num_leaves, js.n).astype(np.int32)
    key = jax.random.key(1)
    cfg = traversal.FMMConfig()
    want = _np(jtrav.resolve_leaf_partners(js, jnp.asarray(pos), jnp.asarray(ax),
                                           jnp.asarray(den), jnp.asarray(my_tgt), key,
                                           jtrav.FMMConfig()))
    leaf = _t(jax.random.gumbel(jax.random.fold_in(key, 10_000), (js.n, js.max_leaf),
                                jnp.float32))
    tree = octree.to_device(octree.build_structure(pos, domain, depth), CPU)
    got = traversal.resolve_leaf_partners(tree, _t(pos), _t(ax), _t(den),
                                          _t(my_tgt).long(), cfg, SlabNoise(leaf=leaf), 0)
    np.testing.assert_array_equal(got.numpy(), want)


def _edges(seed, n=50, e=400, fill=0.7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32),
            rng.uniform(size=e) < fill, rng.uniform(0, 8, n).astype(np.float32),
            rng.uniform(0, 8, n).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_delete_excess_bit_for_bit(seed):
    src, dst, valid, ax, den = _edges(seed)
    key = jax.random.key(seed)
    want = jsyn.delete_excess(jsyn.SynapseState(*map(jnp.asarray, (src, dst, valid))),
                              jnp.asarray(ax), jnp.asarray(den), key)
    k1, k2 = jax.random.split(key)
    bits = [_t(jax.random.bits(k, (src.shape[0],), jnp.uint32)).long() for k in (k1, k2)]
    got = synapses.delete_excess(synapses.SynapseState(*map(_t, (src, dst, valid))),
                                 _t(ax), _t(den), SlabNoise(delete=bits), 0)
    np.testing.assert_array_equal(got.valid.numpy(), _np(want.valid))
    assert got.valid.sum() < valid.sum()


def test_delete_excess_skips_ranking_without_excess():
    src, dst, valid, ax, den = _edges(2, fill=0.0)
    state = synapses.SynapseState(*map(_t, (src, dst, valid)))
    got = synapses.delete_excess(state, _t(ax), _t(den), SlabNoise(), 0)
    assert torch.equal(got.valid, state.valid)


def test_degrees_and_synaptic_input_match_jax():
    src, dst, valid, _, _ = _edges(3)
    n = 50
    spiked = np.random.default_rng(1).uniform(size=n) < 0.4
    sign = np.where(np.arange(n) < 10, -1.0, 1.0).astype(np.float32)
    js = jsyn.SynapseState(*map(jnp.asarray, (src, dst, valid)))
    ps = synapses.SynapseState(*map(_t, (src, dst, valid)))
    np.testing.assert_array_equal(synapses.out_degree(ps, n).numpy(),
                                  _np(jsyn.out_degree(js, n)))
    np.testing.assert_array_equal(synapses.in_degree(ps, n).numpy(),
                                  _np(jsyn.in_degree(js, n)))
    for sg in (None, sign):
        np.testing.assert_array_equal(
            synapses.synaptic_input(ps, _t(spiked), None if sg is None else _t(sg)).numpy(),
            _np(jsyn.synaptic_input(js, jnp.asarray(spiked),
                                    None if sg is None else jnp.asarray(sg))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_conflicts_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    n = 300
    partner = np.where(rng.uniform(size=n) < 0.7, rng.integers(0, 40, n), -1).astype(np.int32)
    req = np.where(partner >= 0, rng.integers(0, 5, n), 0).astype(np.int32)
    cap = rng.integers(0, 6, n).astype(np.int32)
    key = jax.random.key(seed)
    want = _np(jsyn.resolve_conflicts(*map(jnp.asarray, (partner, req, cap)), key))
    prio = _t(jax.random.bits(key, (n,), jnp.uint32)).long()
    got = synapses.resolve_conflicts(_t(partner), _t(req), _t(cap), prio)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < req.sum()


@pytest.mark.parametrize("fill", [0.3, 0.99])
def test_insert_bit_for_bit(fill):
    rng = np.random.default_rng(4)
    n, k = 60, 4
    e = 200
    src, dst = rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32)
    valid = rng.uniform(size=e) < fill
    partner = np.where(rng.uniform(size=n) < 0.6, rng.integers(0, n, n), -1).astype(np.int32)
    accepted = np.where(partner >= 0, rng.integers(0, k + 1, n), 0).astype(np.int32)
    jstate, jdropped = jsyn.insert(jsyn.SynapseState(*map(jnp.asarray, (src, dst, valid))),
                                   jnp.asarray(partner), jnp.asarray(accepted), k)
    state, dropped = synapses.insert(synapses.SynapseState(*map(_t, (src, dst, valid))),
                                     _t(partner), _t(accepted), k)
    for f in synapses.SynapseState._fields:
        np.testing.assert_array_equal(getattr(state, f).numpy(), _np(getattr(jstate, f)))
    assert int(dropped) == int(jdropped)


@pytest.mark.parametrize("n", [1, 2, 3, 255, 256, 1000, 4097])
def test_det_sum_bitwise(n):
    v = np.random.default_rng(n).uniform(0, 1, n).astype(np.float32)
    want = _np(jax.jit(jsyn.det_sum)(jnp.asarray(v)))
    assert synapses.det_sum(_t(v)).numpy() == want
