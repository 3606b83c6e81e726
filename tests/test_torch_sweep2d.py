"""The 2-D (ensemble x data) layout in one process (port of the in-process
half of tests/test_sweep2d.py).

1. A one-rank gloo group forms a 1 x 1 layout: `DistributedEnsembleEngine`
   with K = 4 replicas of a sigma x inhibitory-fraction grid (N = 256, 300
   steps from the seeded mid-growth state of `test_torch_engine`), each
   replica replaying its JAX key's draws, against JAX's
   `DistributedEnsembleEngine` on a 1 x 1 mesh with the same keys and
   params: records exact (synapse counts, spike rates, calcium mean and
   std), edge tables exact; and every replica bit for bit against the
   port's single-device run with the same draws and params row, probes
   included.
2. Between updates the step makes one gather and one merge on the data
   group for the whole block of replicas, and none on the ensemble group.
3. The kind maps of `sharding/rules.py` (`ensemble_sharded_spec` as
   tests/test_sweep2d.py::test_ensemble_sharded_spec_shapes), shard/unshard
   round trips, the routing of `launch.sweep.make_ensemble`, and the
   validation of the layout, the engines and the service.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.core import ensemble, probes
from repro_torch.core.distributed import (DistributedEnsembleEngine,
                                          DistributedPlasticityEngine, sorted_positions)
from repro_torch.core.engine import EngineConfig, PlasticityEngine
from repro_torch.core.traversal import FMMConfig
from repro_torch.launch import mesh, sweep
from repro_torch.sharding import rules
from test_torch_engine import MSP_CFG, JaxReplayNoise, _mid_growth

N, K, STEPS, SEED = 256, 4, 300, 11
FMM_CFG = FMMConfig(c1=8, c2=8, sigma=600.0)
ENGINE_CFG = EngineConfig()
GRID = dict(sigma=[600.0, 750.0], inhibitory_fraction=[0.0, 0.2])
E, D = rules.ENSEMBLE, rules.DATA


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path_factory.mktemp('rdv')}/f",
                            rank=0, world_size=1)
    try:
        yield mesh.make_sweep_groups(1, 1)
    finally:
        dist.destroy_process_group()


def _pset():
    return probes.ProbeSet([probes.SpikeRasterProbe(), probes.CalciumProbe(),
                            probes.TurnoverProbe(np.arange(N) % 3, 3)], chunk_size=STEPS)


@pytest.fixture(scope="module")
def runs(groups):
    import jax
    from jax.sharding import Mesh
    from repro.core import distributed as jdist
    from repro.core import engine as jengine, msp as jmsp, traversal as jtrav
    from repro.launch import sweep as jsweep
    from test_torch_engine import _jax_state
    pos, arrays = _mid_growth(N, SEED)
    spos = sorted_positions(pos, ENGINE_CFG)
    batched = {k: np.stack([v] * K) for k, v in arrays.items()}
    keys = jax.random.split(jax.random.key(SEED), K)
    asdict = dataclasses.asdict
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("ensemble", "data"))
    jeng = jdist.DistributedPlasticityEngine(spos, jmesh, "data", jmsp.MSPConfig(**asdict(MSP_CFG)),
                                             jtrav.FMMConfig(**asdict(FMM_CFG)),
                                             jengine.EngineConfig(**asdict(ENGINE_CFG)))
    jens = jdist.DistributedEnsembleEngine(jeng)
    jparams = jsweep.pack_params(jeng, jsweep.grid(**GRID))
    jst, jrecs = jens.simulate(_jax_state(batched), keys, STEPS, jparams)
    jax.block_until_ready(jrecs.num_synapses)
    counting = mesh.CountingGroup(groups.data)
    ecount = mesh.CountingGroup(groups.ensemble)
    deng = DistributedPlasticityEngine(spos, counting, MSP_CFG, FMM_CFG, ENGINE_CFG, device="cpu")
    ens = DistributedEnsembleEngine(deng, ecount)
    params = convert.params_from_jax({f: np.asarray(v) for f, v in jparams._asdict().items()})
    noises = [JaxReplayNoise(k) for k in keys]
    st0 = ens.shard_states(convert.from_jax_state(batched, "cpu"))
    pset = _pset()
    st, recs, ps = ens.simulate(st0, STEPS, noises=noises, params=params, probes=pset,
                                gather=True)
    ensemble_calls = {k: v["calls"] for k, v in ecount.counts.items()}
    return dict(arrays=arrays, spos=spos, jst=jst, jrecs=jrecs, ens=ens, params=params,
                noises=noises, st=ens.gather_states(st), recs=recs, pset=pset,
                ps=ens.gather_probe_states(pset, ps), counting=counting, ecount=ecount,
                final=st, ensemble_calls=ensemble_calls)


def test_one_by_one_layout_equals_jax_distributed_ensemble(runs):
    """Records and edge tables exactly JAX's (JAX's draws replayed)."""
    jrecs, recs = runs["jrecs"], runs["recs"]
    assert recs.num_synapses.shape == (STEPS, K)
    for f in recs._fields:
        np.testing.assert_array_equal(getattr(recs, f).numpy(), np.asarray(getattr(jrecs, f)),
                                      err_msg=f)
    got = convert.to_numpy(runs["st"])
    for name in ("src", "dst", "valid"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(runs["jst"].edges, name)),
                                      err_msg=name)
    syn = recs.num_synapses.numpy()
    assert (syn[-1] > syn[99]).all() and (syn[99] > 0).all()
    assert len({tuple(c) for c in syn.T}) == K


def test_every_replica_equals_its_single_device_run(runs):
    """Replica k is bit for bit the single engine's run with params row k and
    replica k's draws: records, every state field, probe rows."""
    eng = PlasticityEngine(runs["spos"], MSP_CFG, FMM_CFG, ENGINE_CFG, device="cpu")
    st0 = convert.from_jax_state(runs["arrays"], "cpu")
    pset = _pset()
    for k in range(K):
        st, rec, ps = eng.simulate(st0, STEPS, noise=runs["noises"][k],
                                   params=runs["params"].row(k), probes=pset)
        for f, a, b in zip(rec._fields, rec, runs["recs"]):
            assert torch.equal(a, b[:, k]), (k, f)
        for part in ("neurons", "edges"):
            for f, a, b in zip(getattr(st, part)._fields, getattr(st, part),
                               getattr(runs["st"], part)):
                assert torch.equal(a, b[k]), (k, part, f)
        assert int(st.dropped) == int(runs["st"].dropped[k])
        for name, buf in ps.buffers.items():
            assert torch.equal(buf, runs["ps"].buffers[name][k]), (k, name)
    assert int(runs["ps"].buffers["turnover"].sum()) > 0


def test_one_gather_per_step_for_the_block_and_none_on_the_ensemble_group(runs):
    """99 activity steps (no update): one gather of the block's calcium and
    spikes per step (plus the first step's spike gather) and one merge of
    the synaptic input per step (plus the first synapse count), whatever K;
    no collective on the ensemble group during the run."""
    counting, ecount, ens = runs["counting"], runs["ecount"], runs["ens"]
    # The run with gather=True: the records' one gather after the steps.
    assert runs["ensemble_calls"] == {"gather": 1, "merge": 0, "scatter_sum": 0,
                                      "gather_objects": 0, "gather_to_host": 0}
    counting.reset()
    ecount.reset()
    ens.simulate(runs["final"], 99, noises=runs["noises"], params=runs["params"])
    assert counting.counts["gather"]["calls"] == 99 + 1
    assert counting.counts["merge"]["calls"] == 99 + 1
    assert counting.counts["scatter_sum"]["calls"] == 0
    assert all(c["calls"] == 0 for c in ecount.counts.values())


class _Emulated:
    """The gathers of rank `rank` of a group whose parts are given, in one
    process: gather returns the parts concatenated."""

    def __init__(self, parts, name):
        self.parts, self.name, self.size, self.rank = parts, name, len(parts), 0
        self.device = torch.device("cpu")

    def gather(self, x):
        return torch.cat([p(x) for p in self.parts])


def test_kind_maps_mirror_the_reference():
    """ensemble_sharded_spec of a (K,)-leading state, probe_state_spec,
    ensemble_spec (dim 0, and dim 1 of (T, K) records) and sweep2d_spec."""
    eng = PlasticityEngine(np.random.default_rng(0).uniform(0, 1000.0, (64, 3)).astype(np.float32),
                           device="cpu")
    states = ensemble.EnsembleEngine(eng).init_states(4)
    spec = rules.ensemble_sharded_spec(states)
    assert spec.step == ()                       # the shared host counter
    assert spec.dropped == (E,)
    assert spec.neurons.calcium == (E, D) and spec.edges.src == (E, D)
    assert rules.sweep2d_spec(3, 2) == (E, None, D)
    pspec = rules.probe_state_spec(_pset(), ensemble=True)
    assert pspec.buffers == {"spikes": (E, None, D), "calcium": (E, None, D), "turnover": (E,)}
    assert pspec.cursor == (E,) and rules.probe_state_spec(_pset()).buffers["spikes"] == (None, D)
    assert rules.ensemble_spec(states).neurons.x == (E,)
    assert rules.ensemble_spec({"n_active": np.zeros(4)}) == {"n_active": (E,)}
    recs = rules.ensemble_spec(ensemble.StepRecord(*[torch.zeros(3, 4)] * 4), dim=1)
    assert recs.calcium_mean == (None, E)


@pytest.mark.parametrize("e,d", [(1, 2), (2, 1), (2, 2), (4, 2)])
def test_shard_and_unshard_round_trip(e, d):
    """Cutting a (K, n) value into e x d parts and gathering them back (the
    gathers emulated in one process) gives the value; each part is its
    block of replicas and rows."""
    x = torch.arange(4 * 16).reshape(4, 16)
    kind = (E, D)
    parts = {(c, r): rules.shard(kind, x, r, d, c, e) for c in range(e) for r in range(d)}
    assert torch.equal(parts[(e - 1, d - 1)], x[-4 // e:, -16 // d:])
    # Rank (0, 0): its data row gathers rows, then its column gathers replicas.
    data = _Emulated([lambda t, r=r: parts[(0, r)].movedim(1, 0) for r in range(d)], D)
    col = _Emulated([lambda t, c=c: torch.cat([parts[(c, r)] for r in range(d)], 1)
                     for c in range(e)], E)
    row0 = rules.unshard((None, D), parts[(0, 0)], data)
    assert torch.equal(row0, x[:4 // e])
    assert torch.equal(rules.unshard((E,), row0, None, col), x)
    assert rules.unshard(rules.REPLICATED, x, data) is x


def test_make_ensemble_routes_by_layout(groups):
    """None -> EnsembleEngine; an ensemble group -> EnsembleEngine with a
    mesh; 2-D groups -> DistributedEnsembleEngine (a plain engine rewrapped
    with the default switches, a distributed engine on the layout's data
    group passed through with its own); one on other groups raises."""
    pos = np.random.default_rng(0).uniform(0, 1000.0, (64, 3)).astype(np.float32)
    seng = PlasticityEngine(pos, MSP_CFG, FMM_CFG, device="cpu")
    assert type(sweep.make_ensemble(seng, None)) is ensemble.EnsembleEngine
    one = sweep.make_ensemble(seng, groups.ensemble)
    assert type(one) is ensemble.EnsembleEngine and one.mesh is groups.ensemble
    ens = sweep.make_ensemble(seng, groups)
    assert isinstance(ens, DistributedEnsembleEngine)
    assert (ens.engine.find_phase, ens.engine.pyramid_partials,
            ens.engine.pyramid_exchange) == ("sharded", "owner_span", "gathered")
    deng = DistributedPlasticityEngine(pos, mesh.CountingGroup(groups.data), MSP_CFG, FMM_CFG,
                                       device="cpu", find_phase="replicated")
    assert sweep.make_ensemble(deng, groups).engine is deng
    with pytest.raises(ValueError, match="other groups"):
        sweep.make_ensemble(deng, None)
    other = DistributedPlasticityEngine(pos, mesh.ShapeGroup(1), MSP_CFG, FMM_CFG, device="cpu")
    with pytest.raises(ValueError, match="other groups"):
        sweep.make_ensemble(other, groups)


def test_layout_validation(groups):
    """The reference's messages: a wrong axis name, a world size that is not
    ensemble x data; and K not divisible by the ensemble axis, a service
    whose slots do not divide over it."""
    pos = np.random.default_rng(0).uniform(0, 1000.0, (64, 3)).astype(np.float32)
    deng = DistributedPlasticityEngine(pos, groups.data, MSP_CFG, FMM_CFG, device="cpu")
    with pytest.raises(ValueError, match="no 'replica' axis"):
        DistributedEnsembleEngine(deng, groups.ensemble, ensemble_axis="replica")
    with pytest.raises(ValueError, match="must differ"):
        DistributedEnsembleEngine(deng, mesh.ShapeGroup(1, name="data"), ensemble_axis="data")
    with pytest.raises(ValueError, match="devices"):
        mesh.make_sweep_groups(ensemble=64, data=64)
    three = mesh.ShapeGroup(3, name="ensemble")
    with pytest.raises(ValueError, match="must divide the replica count"):
        DistributedEnsembleEngine(deng, three).init_states(4)
    with pytest.raises(ValueError, match="must divide the replica count"):
        ensemble.EnsembleEngine(PlasticityEngine(pos, device="cpu"), mesh=three).init_states(4)
    from repro_torch.serve import SimulationService
    with pytest.raises(ValueError, match="devices"):
        SimulationService(pos, MSP_CFG, FMM_CFG, num_slots=4, round_steps=100,
                          checkpoint_dir="unused", mesh=three, device="cpu")


def test_run_sweep_on_the_layout_equals_the_plain_sweep(groups):
    """run_sweep with the 1 x 1 groups (the rewrapped engine, records and
    states gathered) equals the plain sweep on the sorted positions."""
    pos = np.random.default_rng(2).uniform(0, 1000.0, (64, 3)).astype(np.float32)
    seng = PlasticityEngine(sorted_positions(pos, ENGINE_CFG), MSP_CFG, FMM_CFG, device="cpu")
    configs = sweep.grid(**GRID)
    a = sweep.run_sweep(seng, configs, num_steps=200, seed=3, mesh=groups)
    b = sweep.run_sweep(seng, configs, num_steps=200, seed=3)
    for x, y in zip(a.records, b.records):
        assert torch.equal(x, y)
    assert torch.equal(a.states.edges.dst, b.states.edges.dst)
    assert sweep.summarize(a) == sweep.summarize(b)
