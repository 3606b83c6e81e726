"""The port's main path as a whole against the JAX engine.

`JaxReplayNoise` derives every draw exactly as the JAX engine derives it
from its key, and hands those draws to the port through the noise interface
(`repro_torch/core/noise.py`).  Both engines then run `simulate` from the
same seeded mid-growth state (N = 256, 300 steps, three connectivity
updates, c1 = c2 = 8), and must agree: per-step synapse counts and spike
rates exactly, the final edge table, refractory counters and spikes exactly,
calcium and synaptic elements within rtol 1e-5 (the growth curve's exp
differs by an ulp between torch and XLA:CPU on some inputs).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import engine as jengine
from repro.core import msp as jmsp
from repro.core import synapses as jsyn
from repro.core import traversal as jtrav
from repro_torch import convert
from repro_torch.core import engine, msp, traversal
from repro_torch.core.noise import GeneratorNoise

N = 256
STEPS = 300
SEED = 11
MSP_CFG = msp.MSPConfig.calibrated(speedup=100.0)
FMM_CFG = traversal.FMMConfig(c1=8, c2=8)
ENGINE_CFG = engine.EngineConfig()


class JaxReplayNoise:
    """The JAX engine's draws, derived from its key as `engine.simulate`
    (`fold_in(key, step)`, split into kact/kconn), `connectivity_update`
    (kconn split in 3), `delete_excess`, `descend` (and the Barnes-Hut
    descent, which draws from the same keys with one row per neuron),
    `resolve_leaf_partners`, `find_partners_direct` and `resolve_conflicts`
    derive them.  The batched draws read only the number of logical indices
    each call names (`repro_torch/core/noise.py`)."""

    def __init__(self, key):
        self.key = key

    def _keys(self, step):
        kact, kconn = jax.random.split(jax.random.fold_in(self.key, step))
        kdel, kfind, kconf = jax.random.split(kconn, 3)
        return kact, kdel, kfind, kconf

    @staticmethod
    def _t(a):
        return torch.from_numpy(np.array(a))

    def spike_uniform(self, step, rows):
        return self._t(jax.random.uniform(self._keys(step)[0], (rows.shape[0],),
                                          jnp.float32))

    def delete_bits(self, step, side, slots):
        k = jax.random.split(self._keys(step)[1])[side]
        return self._t(jax.random.bits(k, (slots.shape[0],), jnp.uint32)).to(torch.int64)

    def descent_gumbel(self, step, level, ids):
        k1 = jax.random.split(self._keys(step)[2])[0]
        return self._t(jax.random.gumbel(jax.random.fold_in(k1, level), (ids.shape[0], 8),
                                         jnp.float32))

    def leaf_gumbel(self, step, rows, max_leaf):
        k2 = jax.random.split(self._keys(step)[2])[1]
        return self._t(jax.random.gumbel(jax.random.fold_in(k2, 10_000),
                                         (rows.shape[0], max_leaf), jnp.float32))

    def direct_gumbel(self, step, rows, n):
        return self._t(jax.random.gumbel(self._keys(step)[2], (rows.shape[0], n),
                                         jnp.float32))

    def conflict_bits(self, step, rows):
        return self._t(jax.random.bits(self._keys(step)[3], (rows.shape[0],), jnp.uint32)
                       ).to(torch.int64)


def _mid_growth(n, seed):
    """Positions and a seeded mid-growth state: calcium U(0.4, 0.7), axonal
    and dendritic elements U(0, 6), no edges."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, ENGINE_CFG.domain, (n, 3)).astype(np.float32)
    state = {
        "x": np.full(n, MSP_CFG.x0, np.float32),
        "refrac": np.zeros(n, np.int32), "spiked": np.zeros(n, bool),
        "calcium": rng.uniform(0.4, 0.7, n).astype(np.float32),
        "ax_elems": rng.uniform(0, 6, n).astype(np.float32),
        "den_elems": rng.uniform(0, 6, n).astype(np.float32),
        "src": np.zeros(n * ENGINE_CFG.edge_capacity_per_neuron, np.int32),
        "dst": np.zeros(n * ENGINE_CFG.edge_capacity_per_neuron, np.int32),
        "valid": np.zeros(n * ENGINE_CFG.edge_capacity_per_neuron, bool),
        "step": np.int32(0), "dropped": np.int32(0)}
    return pos, state


def _jax_state(arrays):
    return jengine.SimState(
        neurons=jmsp.NeuronState(*(jnp.asarray(arrays[k]) for k in jmsp.NeuronState._fields)),
        edges=jsyn.SynapseState(*(jnp.asarray(arrays[k]) for k in jsyn.SynapseState._fields)),
        step=jnp.asarray(arrays["step"], jnp.int32),
        dropped=jnp.asarray(arrays["dropped"], jnp.int32))


def _jax_configs():
    asdict = dataclasses.asdict
    return (jmsp.MSPConfig(**asdict(MSP_CFG)), jtrav.FMMConfig(**asdict(FMM_CFG)),
            jengine.EngineConfig(**asdict(ENGINE_CFG)))


@pytest.fixture(scope="module")
def runs():
    pos, arrays = _mid_growth(N, SEED)
    key = jax.random.key(SEED)
    jeng = jengine.PlasticityEngine(pos, *_jax_configs())
    jst, jrecs = jeng.simulate(_jax_state(arrays), key, STEPS)
    jax.block_until_ready(jrecs.num_synapses)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, ENGINE_CFG, device="cpu")
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
    jst, jrecs, st, recs = runs
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
    """Synapses form at every update and neurons spike, so the equalities
    above are not vacuous."""
    _, _, _, recs = runs
    syn = recs.num_synapses.numpy()
    assert 0 < syn[99] < syn[199] < syn[299]
    assert recs.spike_rate.numpy().mean() > 0


def test_generator_noise_is_deterministic_and_seeded():
    pos, arrays = _mid_growth(64, 3)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, ENGINE_CFG, device="cpu")
    st0 = convert.from_jax_state(arrays, "cpu")
    a, ra = eng.simulate(st0, 200, seed=1)
    b, rb = eng.simulate(st0, 200, seed=1)
    c, rc = eng.simulate(st0, 200, seed=2)
    for name in ("src", "dst", "valid"):
        assert torch.equal(getattr(a.edges, name), getattr(b.edges, name))
    assert torch.equal(ra.num_synapses, rb.num_synapses)
    assert int(ra.num_synapses[-1]) > 0
    assert not torch.equal(ra.spike_rate, rc.spike_rate)


def test_chunked_run_equals_one_run():
    """Draws depend on (seed, step), not on how many draws came before, so
    two chunks of a run reproduce the uninterrupted run."""
    pos, arrays = _mid_growth(64, 4)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, ENGINE_CFG, device="cpu")
    st0 = convert.from_jax_state(arrays, "cpu")
    whole, _ = eng.simulate(st0, 200, seed=5)
    half, _ = eng.simulate(st0, 150, seed=5)
    rest, _ = eng.simulate(half, 50, seed=5)
    assert torch.equal(whole.edges.valid, rest.edges.valid)
    assert torch.equal(whole.neurons.calcium, rest.neurons.calcium)


def test_fig1_calcium_rises_toward_target():
    """Fig. 1's shape from a cold start: mean calcium climbs toward eps."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 1000.0, (128, 3)).astype(np.float32)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, ENGINE_CFG, device="cpu")
    _, recs = eng.simulate(eng.init_state(), 1500, seed=0)
    ca = recs.calcium_mean.numpy()
    assert ca[-1] > ca[100] > 0
    assert ca[-1] < MSP_CFG.eps + 0.1


def test_convert_round_trip_and_configs():
    _, arrays = _mid_growth(32, 0)
    back = convert.to_numpy(convert.from_jax_state(arrays, "cpu"))
    assert set(back) == set(convert.STATE_FIELDS)
    for name in convert.STATE_FIELDS:
        np.testing.assert_array_equal(back[name], arrays[name], err_msg=name)
    jm, jf, je = (dataclasses.asdict(c) for c in _jax_configs())
    assert convert.configs_from_jax(jm, jf, je) == (MSP_CFG, FMM_CFG, ENGINE_CFG)
    # The JAX backend switch has no counterpart: the port's kernels run
    # wherever a card is, whichever backend the JAX run used.
    assert convert.configs_from_jax(jm, jf, {**je, "backend": "pallas"})[2] == ENGINE_CFG
    # guard_delta (the static guard of a sigma sweep) is ported and carried.
    fmm = convert.configs_from_jax(jm, {**jf, "guard_delta": 360000.0}, je)[1]
    assert fmm == dataclasses.replace(FMM_CFG, guard_delta=360000.0)
    assert dataclasses.asdict(fmm)["guard_delta"] == 360000.0


def test_simulate_rejects_unported_arguments():
    """n_active is ported (tests/test_torch_padded.py holds it to the
    isolated run); an active count outside [0, n] is rejected."""
    pos, arrays = _mid_growth(16, 0)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, ENGINE_CFG, device="cpu")
    st = convert.from_jax_state(arrays, "cpu")
    for bad in (17, -1):
        with pytest.raises(ValueError, match="n_active"):
            eng.simulate(st, 1, n_active=bad)
    st1, recs = eng.simulate(st, 1, n_active=8)
    assert st1.step == 1 and not bool(st1.neurons.calcium[8:].any())


def test_simulate_runs_with_params():
    """params= is ported: per-run KernelParams steer the run (here sigma,
    c1, c2 and a quarter of the neurons inhibitory) and leave the state's
    layout as it was."""
    pos, arrays = _mid_growth(64, 1)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, ENGINE_CFG, device="cpu")
    st0 = convert.from_jax_state(arrays, "cpu")
    params = engine.KernelParams(*(np.float32(v) for v in (900.0, 4.0, 4.0, 0.25)))
    st, recs = eng.simulate(st0, 200, seed=3, params=params)
    plain, precs = eng.simulate(st0, 200, seed=3)
    assert st.step == 200 and recs.num_synapses.shape == (200,)
    assert int(recs.num_synapses[-1]) > 0
    assert not torch.equal(st.edges.dst, plain.edges.dst)
    assert eng._runtime_fmm_cfg(params).guard_delta == FMM_CFG.delta
    assert int((eng._runtime_sign(params) < 0).sum()) == 16


def test_step_do_update_overrides_the_schedule():
    """step(do_update=) decides the connectivity update instead of the step
    counter: False skips the update the schedule asks for at step 100,
    True runs one at a step the schedule skips."""
    pos, arrays = _mid_growth(64, 2)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, ENGINE_CFG, device="cpu")
    noise = GeneratorNoise(1, torch.device("cpu"))
    st = convert.from_jax_state(arrays, "cpu")._replace(step=99)
    skipped, rec = eng.step(st, noise, do_update=False)
    assert skipped.step == 100 and skipped.edges.valid is st.edges.valid
    assert int(rec.num_synapses) == 0
    scheduled, rec = eng.step(st, noise)
    assert int(rec.num_synapses) > 0
    forced, rec = eng.step(st._replace(step=42), noise, do_update=True)
    assert forced.step == 43 and int(rec.num_synapses) > 0


@pytest.mark.parametrize("chunk", [5, 7])
def test_taylor_chunk_matches_jax_and_the_unchunked_run(chunk):
    """FMMConfig.taylor_chunk maps the Taylor tier over chunks of that many
    source boxes: the run equals the JAX engine's with the same value (as
    `runs` holds it: exact records and edge tables, calcium at rtol 1e-5)
    and the port's unchunked run bit for bit.  The occupied-box counts are
    8 and 63 here: 5 divides neither, 7 divides the second."""
    chunked = dataclasses.replace(FMM_CFG, taylor_chunk=chunk)
    pos, arrays = _mid_growth(N, SEED)
    key = jax.random.key(SEED)
    jm, jf, je = _jax_configs()
    jeng = jengine.PlasticityEngine(pos, jm, dataclasses.replace(jf, taylor_chunk=chunk), je)
    jst, jrecs = jeng.simulate(_jax_state(arrays), key, STEPS)
    eng = engine.PlasticityEngine(pos, MSP_CFG, chunked, ENGINE_CFG, device="cpu")
    occ = [eng.tree.levels[l].occupied.shape[0] for l in range(1, eng.structure.depth + 1)]
    assert occ == [8, 63]
    st, recs = eng.simulate(convert.from_jax_state(arrays, "cpu"), STEPS,
                            noise=JaxReplayNoise(key))
    np.testing.assert_array_equal(recs.num_synapses.numpy(), np.asarray(jrecs.num_synapses))
    np.testing.assert_array_equal(recs.spike_rate.numpy(), np.asarray(jrecs.spike_rate))
    np.testing.assert_allclose(recs.calcium_mean.numpy(), np.asarray(jrecs.calcium_mean),
                               rtol=1e-5)
    for name in ("src", "dst", "valid"):
        np.testing.assert_array_equal(convert.to_numpy(st)[name],
                                      np.asarray(getattr(jst.edges, name)), err_msg=name)
    plain = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, ENGINE_CFG, device="cpu")
    pst, precs = plain.simulate(convert.from_jax_state(arrays, "cpu"), STEPS,
                                noise=JaxReplayNoise(key))
    for a, b in zip(recs, precs):
        assert torch.equal(a, b)
    for a, b in zip(st.edges + st.neurons, pst.edges + pst.neurons):
        assert torch.equal(a, b)
    assert convert.configs_from_jax(dataclasses.asdict(jm), {**dataclasses.asdict(jf),
                                                             "taylor_chunk": chunk},
                                    dataclasses.asdict(je))[1] == chunked


# -- the records' synapse count, carried between updates ------------------------------

INTERVAL = 10
# (steps run before the call, the call's chunks): one call over several
# updates, the benchmark's [interval - 1, 1] chunks, a call that opens on an
# update step.
CARRY_CASES = {"one_call": (0, [35]), "interval_chunks": (0, [INTERVAL - 1, 1] * 3),
               "first_step_updates": (INTERVAL - 1, [21])}


@pytest.mark.parametrize("n_active", [None, 48], ids=["whole", "padded"])
@pytest.mark.parametrize("start, chunks", CARRY_CASES.values(), ids=list(CARRY_CASES))
def test_carried_synapse_count_equals_single_steps(start, chunks, n_active):
    """`simulate` counts the edge table on its first step and after each
    update and carries the count over the steps between; its records and
    state equal repeated single `step` calls, each of which counts the
    table afresh, bit for bit (padded state too)."""
    pos, arrays = _mid_growth(64, 7)
    cfg = dataclasses.replace(MSP_CFG, update_interval=INTERVAL)
    eng = engine.PlasticityEngine(pos, cfg, FMM_CFG, ENGINE_CFG, device="cpu")
    noise = GeneratorNoise(3, torch.device("cpu"))
    st = want_st = convert.from_jax_state(arrays, "cpu")
    want = []
    for i in range(start + sum(chunks)):
        want_st, rec = eng.step(want_st, noise, n_active=n_active)
        want.append(rec)
        if i + 1 == start:
            st = want_st
    want = engine.stack_records(want[start:], "cpu")
    got = []
    for steps in chunks:
        st, rec = eng.simulate(st, steps, noise=noise, n_active=n_active)
        got.append(rec)
    for f in engine.StepRecord._fields:
        assert torch.equal(torch.cat([getattr(r, f) for r in got]), getattr(want, f)), f
    for f, a, b in zip(st.edges._fields, st.edges, want_st.edges):
        assert torch.equal(a, b), f
    assert len(set(want.num_synapses.tolist())) >= 3
