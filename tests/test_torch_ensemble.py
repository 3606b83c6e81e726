"""The port's ensemble and sweep against the JAX package's.

K = 4 replicas of N = 256 neurons from the seeded mid-growth state of
`test_torch_engine`, 300 steps (three connectivity updates), with a sigma x
inhibitory-fraction grid of per-replica `KernelParams` (the engine's static
sigma is the sweep minimum).  Each port replica replays its JAX key's draws
(`JaxReplayNoise`).  The JAX `EnsembleEngine` runs the same batch with the
knobs traced.  Synapse counts, spike rates and edge tables must agree
exactly, calcium within rtol 1e-5 (the growth curve's exp).  The port's
batch must also equal K sequential port runs bit for bit, and identity
params the plain path.
"""
import dataclasses

import numpy as np
import pytest
import jax
import torch

from repro.core import engine as jengine
from repro.core import ensemble as jensemble
from repro.core import msp as jmsp
from repro.core import traversal as jtrav
from repro.launch import sweep as jsweep
from repro_torch import convert
from repro_torch.core import engine, ensemble, traversal
from repro_torch.launch import sweep
from test_torch_engine import (CARRY_CASES, INTERVAL, MSP_CFG, JaxReplayNoise, _jax_state,
                               _mid_growth)

N, K, STEPS, SEED = 256, 4, 300, 11
FMM_CFG = traversal.FMMConfig(c1=8, c2=8, sigma=600.0)
ENGINE_CFG = engine.EngineConfig()
GRID = dict(sigma=[600.0, 750.0], inhibitory_fraction=[0.0, 0.2])


def _jax_engine(pos):
    asdict = dataclasses.asdict
    return jengine.PlasticityEngine(pos, jmsp.MSPConfig(**asdict(MSP_CFG)),
                                    jtrav.FMMConfig(**asdict(FMM_CFG)),
                                    jengine.EngineConfig(**asdict(ENGINE_CFG)))


def _port_engine(pos):
    return engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, ENGINE_CFG, device="cpu")


@pytest.fixture(scope="module")
def runs():
    pos, arrays = _mid_growth(N, SEED)
    batched = {k: np.stack([v] * K) for k, v in arrays.items()}
    keys = jax.random.split(jax.random.key(SEED), K)
    jeng = _jax_engine(pos)
    jparams = jsweep.pack_params(jeng, jsweep.grid(**GRID))
    jst, jrecs = jensemble.EnsembleEngine(jeng).simulate(_jax_state(batched), keys, STEPS,
                                                         jparams)
    jax.block_until_ready(jrecs.num_synapses)
    eng = _port_engine(pos)
    params = convert.params_from_jax({f: np.asarray(v) for f, v in jparams._asdict().items()})
    noises = [JaxReplayNoise(k) for k in keys]
    st, recs = ensemble.EnsembleEngine(eng).simulate(convert.from_jax_state(batched, "cpu"),
                                                     STEPS, noises=noises, params=params)
    return dict(pos=pos, arrays=arrays, batched=batched, eng=eng, params=params,
                noises=noises, jst=jst, jrecs=jrecs, st=st, recs=recs)


def test_records_match_jax_ensemble(runs):
    jrecs, recs = runs["jrecs"], runs["recs"]
    assert recs.num_synapses.shape == (STEPS, K)
    np.testing.assert_array_equal(recs.num_synapses.numpy(), np.asarray(jrecs.num_synapses))
    np.testing.assert_array_equal(recs.spike_rate.numpy(), np.asarray(jrecs.spike_rate))
    for f in ("calcium_mean", "calcium_std"):
        np.testing.assert_allclose(getattr(recs, f).numpy(), np.asarray(getattr(jrecs, f)),
                                   rtol=1e-5, err_msg=f)
    syn = recs.num_synapses.numpy()
    assert (syn[-1] > syn[99]).all() and (syn[99] > 0).all()
    assert len({tuple(c) for c in syn.T}) == K        # the replicas differ


def test_final_state_matches_jax_ensemble(runs):
    jst, got = runs["jst"], convert.to_numpy(runs["st"])
    for name in ("src", "dst", "valid"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jst.edges, name)),
                                      err_msg=name)
    for name in ("refrac", "spiked"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jst.neurons, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got["calcium"], np.asarray(jst.neurons.calcium), rtol=1e-5)
    np.testing.assert_array_equal(got["step"], np.asarray(jst.step))
    np.testing.assert_array_equal(got["dropped"], np.asarray(jst.dropped))


def test_batch_equals_sequential_port_runs(runs):
    """Replica k of the batch is bit for bit the single engine's run with
    params row k and replica k's draws."""
    eng, st0 = runs["eng"], convert.from_jax_state(runs["arrays"], "cpu")
    for k in range(K):
        st, rec = eng.simulate(st0, STEPS, noise=runs["noises"][k], params=runs["params"].row(k))
        for f, a, b in zip(rec._fields, rec, runs["recs"]):
            assert torch.equal(a, b[:, k]), (k, f)
        for part in ("neurons", "edges"):
            for f, a, b in zip(getattr(st, part)._fields, getattr(st, part),
                               getattr(runs["st"], part)):
                assert torch.equal(a, b[k]), (k, part, f)
        assert int(st.dropped) == int(runs["st"].dropped[k])


def test_identity_params_equal_the_plain_path():
    """Params from the static configs give the plain path's run bit for bit,
    for the single engine and for an ensemble's default params."""
    pos, arrays = _mid_growth(64, 2)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG,
                                  engine.EngineConfig(inhibitory_fraction=0.25), device="cpu")
    st0 = convert.from_jax_state(arrays, "cpu")
    plain, rp = eng.simulate(st0, 200, seed=4)
    ident, ri = eng.simulate(st0, 200, seed=4,
                             params=engine.KernelParams.from_configs(eng.fmm_cfg, eng.engine_cfg))
    for a, b in zip(rp, ri):
        assert torch.equal(a, b)
    assert torch.equal(plain.edges.valid, ident.edges.valid)
    assert int(rp.num_synapses[-1]) > 0
    ens = ensemble.EnsembleEngine(eng)
    sts = ensemble.stack_states([st0] * 2)
    a, ra = ens.simulate(sts, 200, seed=4)
    b, rb = ens.simulate(sts, 200, seed=4, params=ens.default_params(2))
    for x, y in zip(ra, rb):
        assert torch.equal(x, y)
    assert torch.equal(a.edges.dst, b.edges.dst)


def test_params_change_the_run_as_the_static_configs_would():
    """A params row equal to another engine's static configs reproduces that
    engine's plain run (here c1 = c2 = 70 against the engine's 8)."""
    pos, arrays = _mid_growth(64, 3)
    st0 = convert.from_jax_state(arrays, "cpu")
    eng = _port_engine(pos)
    other = engine.PlasticityEngine(pos, MSP_CFG, dataclasses.replace(FMM_CFG, c1=70.0, c2=70.0),
                                    ENGINE_CFG, device="cpu")
    want, rw = other.simulate(st0, 200, seed=6)
    got, rg = eng.simulate(st0, 200, seed=6, params=engine.KernelParams.from_configs(
        other.fmm_cfg, other.engine_cfg))
    assert torch.equal(rw.num_synapses, rg.num_synapses)
    assert torch.equal(want.edges.src, got.edges.src)


def test_mid_interval_continuation_keeps_the_update_schedule(runs):
    """150 + 150 steps (the cut falls mid-interval) equal the 300-step batch,
    and hence the JAX ensemble: updates stay on steps 100, 200 and 300."""
    ens = ensemble.EnsembleEngine(runs["eng"])
    st = convert.from_jax_state(runs["batched"], "cpu")
    st, r1 = ens.simulate(st, 150, noises=runs["noises"], params=runs["params"])
    st, r2 = ens.simulate(st, 150, noises=runs["noises"], params=runs["params"])
    assert st.step == STEPS
    np.testing.assert_array_equal(torch.cat([r1.num_synapses, r2.num_synapses]).numpy(),
                                  np.asarray(runs["jrecs"].num_synapses))
    for f in ("src", "dst", "valid"):
        assert torch.equal(getattr(st.edges, f), getattr(runs["st"].edges, f))
    jumps = np.nonzero(np.diff(runs["recs"].num_synapses.numpy()[:, 0]))[0] + 1
    assert set(jumps) <= {99, 199, 299}


def test_sweep_helpers_match_jax():
    pos, _ = _mid_growth(64, 0)
    configs = sweep.grid(**GRID)
    assert configs == jsweep.grid(**GRID)
    assert sweep.grid(c2=[1, 2], sigma=[3]) == jsweep.grid(c2=[1, 2], sigma=[3])
    with pytest.raises(ValueError):
        sweep.grid(tau=[1.0])
    eng, jeng = _port_engine(pos), _jax_engine(pos)
    partial = [{"sigma": 650.0}, {"c1": 3.0, "inhibitory_fraction": 0.1}]
    got, want = sweep.pack_params(eng, partial), jsweep.pack_params(jeng, partial)
    for f in engine.KernelParams._fields:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
        assert getattr(got, f).dtype == np.float32


def test_run_sweep_and_summarize_match_jax():
    """run_sweep from the engine's initial state, reduced by summarize: the
    same rows as the JAX package's, the port replaying JAX's per-replica
    keys (seed 3, 300 steps, N = 64, tail 100)."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 1000.0, (64, 3)).astype(np.float32)
    configs = sweep.grid(sigma=[600.0, 900.0], c1=[4.0])
    jres = jsweep.run_sweep(_jax_engine(pos), configs, num_steps=300, seed=3, replicates=2,
                            tail=100)
    keys = jax.random.split(jax.random.key(3), 4)
    res = sweep.run_sweep(_port_engine(pos), configs, num_steps=300, replicates=2, tail=100,
                          noises=[JaxReplayNoise(k) for k in keys])
    rows, jrows = sweep.summarize(res), jsweep.summarize(jres)
    assert [r["replica"] for r in rows] == [0, 1, 2, 3]
    for r, j in zip(rows, jrows):
        assert set(r) == set(j)
        for key in ("sigma", "c1", "replica", "synapses_end", "dropped", "spike_rate"):
            assert r[key] == j[key], key
        np.testing.assert_allclose(r["calcium_end"], j["calcium_end"], rtol=1e-5)
    assert rows[0]["spike_rate"] > 0


def test_sweep_warns_when_the_static_sigma_is_not_the_minimum():
    pos, _ = _mid_growth(32, 0)
    eng = engine.PlasticityEngine(pos, MSP_CFG, traversal.FMMConfig(c1=8, c2=8, sigma=750.0),
                                  ENGINE_CFG, device="cpu")
    with pytest.warns(UserWarning, match="sweep minimum"):
        sweep.run_sweep(eng, sweep.grid(sigma=[600.0]), num_steps=2)


def test_sweep_demo_runs_on_the_cpu(capsys):
    sweep.main(["--device", "cpu"], num_steps=150)
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["sigma", "inh_frac", "calcium", "synapses", "rate"]
    assert len(out) == 6 and out[-1] == "device: cpu"


def test_a_replica_mesh_is_not_ported():
    """The replica mesh is ported (tests/test_torch_mesh_gloo.py runs it):
    an object that is no ensemble group raises, as the reference raises for
    a mesh without the axis; an ensemble group of 2 holds half the
    replicas."""
    from repro_torch.launch.mesh import ShapeGroup
    pos, _ = _mid_growth(16, 0)
    eng = _port_engine(pos)
    with pytest.raises(ValueError, match="no 'ensemble' axis"):
        ensemble.EnsembleEngine(eng, mesh=object())
    with pytest.raises(ValueError, match="no 'ensemble' axis"):
        sweep.make_ensemble(eng, mesh=object())
    half = sweep.make_ensemble(eng, mesh=ShapeGroup(2, 1, name="ensemble"))
    assert half.init_states(4).dropped.shape == (2,)


def test_ensemble_states_round_trip_through_convert(runs):
    back = convert.to_numpy(convert.from_jax_state(runs["batched"], "cpu"))
    for name in convert.STATE_FIELDS:
        np.testing.assert_array_equal(back[name], runs["batched"][name], err_msg=name)
    uneven = dict(runs["batched"], step=np.arange(K, dtype=np.int32))
    with pytest.raises(ValueError, match="lockstep"):
        convert.from_jax_state(uneven, "cpu")
    p = convert.params_to_numpy(runs["params"])
    assert p["sigma"].tolist() == [600.0, 600.0, 750.0, 750.0]
    assert all(np.array_equal(a, b) for a, b in zip(convert.params_from_jax(p), runs["params"]))


# -- the records' synapse count, carried between updates ------------------------------

def _recount_every_step(ens, states, steps, noises):
    """`steps` steps of `ens`, each step's records counting the tables afresh."""
    rows = [None] * states.dropped.shape[0]
    signs = ensemble.stacked_signs(ens.engine, rows)
    recs = []
    for _ in range(steps):
        states, rec = ens._step(states, noises, rows, signs, num_synapses=None)
        recs.append(rec)
    return states, engine.stack_records(recs, "cpu")


@pytest.mark.parametrize("start, chunks", CARRY_CASES.values(), ids=list(CARRY_CASES))
def test_carried_synapse_count_equals_a_recount_every_step(start, chunks):
    """`simulate` counts the edge tables on its first step and after each
    update and carries the count over the steps between; its records and
    state equal a loop that recounts every step, bit for bit."""
    pos, arrays = _mid_growth(64, 7)
    cfg = dataclasses.replace(MSP_CFG, update_interval=INTERVAL)
    ens = ensemble.EnsembleEngine(engine.PlasticityEngine(pos, cfg, FMM_CFG, ENGINE_CFG,
                                                          device="cpu"))
    noises = ensemble.replica_noises(3, 2, torch.device("cpu"))
    st0 = convert.from_jax_state({k: np.stack([v] * 2) for k, v in arrays.items()}, "cpu")
    want_st, want = _recount_every_step(ens, st0, start + sum(chunks), noises)
    st, _ = _recount_every_step(ens, st0, start, noises)
    got = []
    for steps in chunks:
        st, rec = ens.simulate(st, steps, noises=noises)
        got.append(rec)
    for f in engine.StepRecord._fields:
        assert torch.equal(torch.cat([getattr(r, f) for r in got]), getattr(want, f)[start:]), f
    for f, a, b in zip(st.edges._fields, st.edges, want_st.edges):
        assert torch.equal(a, b), f
    syn = want.num_synapses[start:].numpy()
    assert len(set(syn[:, 0].tolist())) >= 3 and (syn[:, 0] != syn[:, 1]).any()
