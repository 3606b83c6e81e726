"""Padded subdomains and counter-mode draws in the port.

1. A padded port run (`simulate(n_active=m)` on a 64-neuron pool) equals
   the isolated port run of the pool's first m positions bit for bit:
   records, the neuron rows, the edge-table prefix with no valid edge past
   it, probe rows with inert pad columns; for fmm (segsum and m2m
   pyramids), barnes_hut, direct and an inhibitory fraction of 0.2, at
   m in {17, 48, 64}, and through a forced-deletion continuation.
2. The port's isolated `rng="counter"` run equals the JAX engine's isolated
   `rng="counter"` run with the draws of `repro.core.streams` replayed
   (`JaxCounterReplayNoise`), to tests/test_torch_engine.py's standard:
   synapse counts, spike rates and edge tables exactly, calcium and the
   elements within rtol 1e-5.
3. The masked `msp.step_neurons` equals JAX's `step_neurons(mask=,
   rng="counter")` with the same draws.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import engine as jengine
from repro.core import msp as jmsp
from repro.core import streams as jstreams
from repro_torch import convert
from repro_torch.core import engine, msp, traversal
from repro_torch.core.probes import CalciumProbe, ProbeSet, SpikeRasterProbe

from test_torch_engine import (FMM_CFG, MSP_CFG, N, SEED, STEPS, JaxReplayNoise, _jax_configs,
                               _jax_state, _mid_growth)

POOL = 64
PAD_STEPS = 300        # three connectivity updates
DEL_STEPS = 100        # forced-deletion continuation
SPEEDUP = 400.0        # synapses form within the run at this scale
CASES = {
    "fmm": dict(method="fmm"),
    "fmm-m2m": dict(method="fmm", pyramid="m2m"),
    "barnes_hut": dict(method="barnes_hut"),
    "direct": dict(method="direct"),
    "fmm-inhibitory": dict(method="fmm", inhibitory_fraction=0.2),
}


def _pool_engines(case, m):
    pos = np.random.default_rng(42).uniform(0, 1000, (POOL, 3)).astype(np.float32)
    msp_cfg = msp.MSPConfig.calibrated(speedup=SPEEDUP)
    fmm_cfg = traversal.FMMConfig(c1=8, c2=8)
    cfg = engine.EngineConfig(rng="counter", **CASES[case])
    pad = engine.PlasticityEngine(pos, msp_cfg, fmm_cfg, cfg, device="cpu")
    # The isolated engine keeps the pool's octree depth.
    iso_cfg = dataclasses.replace(cfg, depth=pad.structure.depth)
    iso = engine.PlasticityEngine(pos[:m], msp_cfg, fmm_cfg, iso_cfg, device="cpu")
    return pad, iso


def _pset():
    return ProbeSet([SpikeRasterProbe(), CalciumProbe()], chunk_size=PAD_STEPS)


def _force_deletion(state, m):
    """Zero the first m rows' elements, so the next update must delete."""
    nrn = state.neurons
    ax, den = nrn.ax_elems.clone(), nrn.den_elems.clone()
    ax[:m] = 0.0
    den[:m] = 0.0
    return state._replace(neurons=nrn._replace(ax_elems=ax, den_elems=den))


def _assert_state_prefix(pad_st, iso_st, iso, m, what):
    for f, a, b in zip(iso_st.neurons._fields, pad_st.neurons, iso_st.neurons):
        assert torch.equal(a[:m], b), f"{what}: neurons.{f}"
        assert not a[m:].any(), f"{what}: neurons.{f} pad rows not inert"
    cap = iso.edge_capacity
    for f, a, b in zip(iso_st.edges._fields, pad_st.edges, iso_st.edges):
        assert torch.equal(a[:cap], b), f"{what}: edges.{f}"
    assert not pad_st.edges.valid[cap:].any(), f"{what}: an edge past the prefix"
    assert pad_st.step == iso_st.step and torch.equal(pad_st.dropped, iso_st.dropped)


def _assert_records(a, b, what):
    for f, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f"{what}: records.{f}"


@pytest.mark.parametrize("m", [17, 48, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_padded_run_equals_isolated_run(case, m):
    pad, iso = _pool_engines(case, m)
    st_p, rec_p, ps_p = pad.simulate(pad.init_state(), PAD_STEPS, seed=7, probes=_pset(),
                                     n_active=m)
    st_i, rec_i, ps_i = iso.simulate(iso.init_state(), PAD_STEPS, seed=7, probes=_pset())
    what = f"{case} m={m}"
    _assert_records(rec_p, rec_i, what)
    _assert_state_prefix(st_p, st_i, iso, m, what)
    for name, buf in ps_p.buffers.items():
        assert torch.equal(buf[:, :m], ps_i.buffers[name]), f"{what}: probe {name}"
        assert not buf[:, m:].any(), f"{what}: probe {name} pad columns not inert"
    # not vacuous: synapses formed and neurons spiked
    assert int(rec_i.num_synapses[-1]) > 0 and float(rec_i.spike_rate.sum()) > 0
    if case == "fmm-inhibitory":
        assert pad._runtime_sign(None, m) is not None


@pytest.mark.parametrize("frac", [0.1, 0.2, 0.33, 0.35, 0.7])
def test_padded_sign_equals_isolated_sign(frac):
    """For every m up to a pool of 256, a padded slot's inhibitory rows are
    the isolated m-neuron engine's (int(f * m) in float64), with +1 on the
    pad rows.  floor(float32(f) * float32(m)) differs at f = 0.35, m = 180
    and f = 0.7, m = 90."""
    pos = np.random.default_rng(3).uniform(0, 1000, (256, 3)).astype(np.float32)
    cfg = engine.EngineConfig(inhibitory_fraction=frac, depth=2)
    pad = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, cfg, device="cpu")
    for m in range(1, 257):
        iso = engine.PlasticityEngine(pos[:m], MSP_CFG, FMM_CFG, cfg, device="cpu")
        want = torch.ones(256)
        if iso.sign is not None:
            want[:m] = iso.sign
        got = pad._runtime_sign(None, m)
        got = torch.ones(256) if got is None else got
        assert torch.equal(got, want), f"f={frac} m={m}"


def test_padded_run_at_a_float32_rounding_fraction_equals_isolated_run():
    """f = 0.35, m = 180 in a pool of 256 (fmm, counter draws): int(f * m) =
    62 inhibitory neurons in both runs (floor(float32(f) * float32(m)) would
    make neuron 62 inhibitory too), so the padded run is its isolated run
    bit for bit: records, neuron rows and edge tables, held every 10 steps
    of 300.  Neuron 62 starts spiking (x = 1) with 16 synapses onto rows
    100..115, so its sign reaches their x at once."""
    pos = np.random.default_rng(42).uniform(0, 1000, (256, 3)).astype(np.float32)
    msp_cfg = msp.MSPConfig.calibrated(speedup=SPEEDUP)
    fmm_cfg = traversal.FMMConfig(c1=8, c2=8)
    cfg = engine.EngineConfig(rng="counter", inhibitory_fraction=0.35)
    pad = engine.PlasticityEngine(pos, msp_cfg, fmm_cfg, cfg, device="cpu")
    iso = engine.PlasticityEngine(pos[:180], msp_cfg, fmm_cfg,
                                  dataclasses.replace(cfg, depth=pad.structure.depth),
                                  device="cpu")
    assert int((iso.sign < 0).sum()) == 62
    g = np.random.default_rng(5)
    rows = {f: g.uniform(lo, hi, 180).astype(np.float32)
            for f, lo, hi in (("calcium", 0.4, 0.7), ("ax_elems", 0, 6), ("den_elems", 1, 6))}
    rows["x"] = np.full(180, msp_cfg.x0, np.float32)
    rows["x"][62], rows["ax_elems"][62] = 1.0, 16.5

    def start(eng):
        st = eng.init_state()
        pad_rows = lambda v: torch.as_tensor(np.pad(v, (0, eng.n - 180)))
        edges = st.edges
        src, dst, valid = edges.src.clone(), edges.dst.clone(), edges.valid.clone()
        src[:16], dst[:16], valid[:16] = 62, torch.arange(100, 116), True
        return st._replace(neurons=st.neurons._replace(**{f: pad_rows(v) for f, v in rows.items()}),
                           edges=edges._replace(src=src, dst=dst, valid=valid))
    st_p, st_i = start(pad), start(iso)
    for chunk in range(PAD_STEPS // 10):
        st_p, rec_p = pad.simulate(st_p, 10, seed=7, n_active=180)
        st_i, rec_i = iso.simulate(st_i, 10, seed=7)
        what = f"f=0.35 m=180 steps {10 * chunk}..{10 * chunk + 9}"
        _assert_records(rec_p, rec_i, what)
        _assert_state_prefix(st_p, st_i, iso, 180, what)
    assert int(rec_i.num_synapses[-1]) > 16


@pytest.mark.parametrize("m", [17, 48])
def test_forced_deletion_padded_equals_isolated(m):
    """The elements are zeroed on the step before an update, so that update
    must delete every synapse (the elements regrow too fast for natural
    deletions at this scale)."""
    pad, iso = _pool_engines("fmm", m)
    steps = PAD_STEPS + DEL_STEPS - 1
    st_p, _ = pad.simulate(pad.init_state(), steps, seed=7, n_active=m)
    st_i, rec_i = iso.simulate(iso.init_state(), steps, seed=7)
    st_p2, rec_p2 = pad.simulate(_force_deletion(st_p, m), 1, seed=7, n_active=m)
    st_i2, rec_i2 = iso.simulate(_force_deletion(st_i, m), 1, seed=7)
    assert int(rec_i2.num_synapses[-1]) < int(rec_i.num_synapses[-1]), "no deletions"
    _assert_records(rec_p2, rec_i2, f"deletion m={m}")
    _assert_state_prefix(st_p2, st_i2, iso, m, f"deletion m={m}")


# -- against the JAX engine's counter mode ------------------------------------

_uniform_at = jax.jit(jstreams.uniform_at)
_bits_at = jax.jit(jstreams.bits_at)
_gumbel_grid = jax.jit(jstreams.gumbel_grid)


def _j(idx):
    return jnp.asarray(idx.numpy(), jnp.int32)


class JaxCounterReplayNoise(JaxReplayNoise):
    """The JAX engine's counter-mode draws (`repro.core.streams`), from the
    keys `JaxReplayNoise` derives, at the logical indices the port names."""

    def spike_uniform(self, step, rows):
        return self._t(_uniform_at(self._keys(step)[0], _j(rows)))

    def delete_bits(self, step, side, slots):
        k = jax.random.split(self._keys(step)[1])[side]
        return self._t(_bits_at(k, _j(slots))).to(torch.int64)

    def descent_gumbel(self, step, level, ids):
        k1 = jax.random.split(self._keys(step)[2])[0]
        return self._t(_gumbel_grid(jax.random.fold_in(k1, level), _j(ids),
                                    jnp.arange(8, dtype=jnp.int32)))

    def leaf_gumbel(self, step, rows, max_leaf):
        k2 = jax.random.split(self._keys(step)[2])[1]
        return self._t(_gumbel_grid(jax.random.fold_in(k2, 10_000), _j(rows),
                                    jnp.arange(max_leaf, dtype=jnp.int32)))

    def direct_gumbel(self, step, rows, n):
        return self._t(_gumbel_grid(self._keys(step)[2], _j(rows),
                                    jnp.arange(n, dtype=jnp.int32)))

    def conflict_bits(self, step, rows):
        return self._t(_bits_at(self._keys(step)[3], _j(rows))).to(torch.int64)


@pytest.fixture(scope="module")
def counter_runs():
    pos, arrays = _mid_growth(N, SEED)
    key = jax.random.key(SEED)
    jmsp_cfg, jfmm_cfg, jeng_cfg = _jax_configs()
    jeng = jengine.PlasticityEngine(pos, jmsp_cfg, jfmm_cfg,
                                    dataclasses.replace(jeng_cfg, rng="counter"))
    jst, jrecs = jeng.simulate(_jax_state(arrays), key, STEPS)
    jax.block_until_ready(jrecs.num_synapses)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, engine.EngineConfig(rng="counter"),
                                  device="cpu")
    st, recs = eng.simulate(convert.from_jax_state(arrays, "cpu"), STEPS,
                            noise=JaxCounterReplayNoise(key))
    return jst, jrecs, st, recs


def test_counter_run_records_match_jax(counter_runs):
    jst, jrecs, st, recs = counter_runs
    np.testing.assert_array_equal(recs.num_synapses.numpy(), np.asarray(jrecs.num_synapses))
    np.testing.assert_array_equal(recs.spike_rate.numpy(), np.asarray(jrecs.spike_rate))
    np.testing.assert_allclose(recs.calcium_mean.numpy(), np.asarray(jrecs.calcium_mean),
                               rtol=1e-5)
    np.testing.assert_allclose(recs.calcium_std.numpy(), np.asarray(jrecs.calcium_std),
                               rtol=1e-5)
    assert int(recs.num_synapses[-1]) > 0


def test_counter_run_final_state_matches_jax(counter_runs):
    jst, jrecs, st, recs = counter_runs
    got = convert.to_numpy(st)
    for name in ("src", "dst", "valid"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jst.edges, name)),
                                      err_msg=name)
    for name in ("refrac", "spiked"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jst.neurons, name)),
                                      err_msg=name)
    for name in ("calcium", "ax_elems", "den_elems"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(jst.neurons, name)),
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("m", [1000, 4000])
def test_masked_step_neurons_matches_jax_counter(m):
    """Pad rows inert after the update, active rows untouched: x, refrac,
    spiked and calcium bit for bit; the elements too on the pad rows, and
    within rtol 1e-5 on the active rows (the growth curve's exp differs by
    an ulp between torch and XLA:CPU on some inputs,
    tests/test_torch_kernels.py)."""
    cfg = msp.MSPConfig.calibrated(speedup=100.0)
    n = 4096
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 0.2, n).astype(np.float32)
    refrac = rng.integers(0, 5, n).astype(np.int32)
    spiked = rng.uniform(size=n) < 0.1
    ca = rng.uniform(0, 1, n).astype(np.float32)
    ax = rng.uniform(0, 6, n).astype(np.float32)
    den = rng.uniform(0, 6, n).astype(np.float32)
    syn = rng.integers(0, 4, n).astype(np.float32)
    mask = np.arange(n) < m
    key = jax.random.key(5)
    step = jax.jit(lambda s, syn_in, mk: jmsp.step_neurons(
        s, syn_in, key, jmsp.MSPConfig(**dataclasses.asdict(cfg)), mask=mk, rng="counter"))
    want = step(jmsp.NeuronState(*map(jnp.asarray, (x, refrac, spiked, ca, ax, den))),
                jnp.asarray(syn), jnp.asarray(mask))
    u = torch.from_numpy(np.array(_uniform_at(key, jnp.arange(n, dtype=jnp.int32))))
    got = msp.step_neurons(msp.NeuronState(*map(torch.from_numpy, (x, refrac, spiked, ca,
                                                                   ax, den))),
                           torch.from_numpy(syn), cfg, u=u, mask=torch.from_numpy(mask))
    for name in ("x", "refrac", "spiked", "calcium"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("ax_elems", "den_elems"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g[m:], w[m:], err_msg=name)
        assert not g[m:].any()
        np.testing.assert_allclose(g[:m], w[:m], rtol=1e-5, err_msg=name)
    assert bool(got.spiked[:m].any()) and not bool(got.spiked[m:].any())
