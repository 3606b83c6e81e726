"""`mesh=` on the ensemble and the service: two gloo ranks in spawned CPU
processes, an ensemble group of e = 2 (`run_ranks(2, ..., ensemble=2)`).

1. `EnsembleEngine(mesh=)`: K = 4 replicas of a sigma x inhibitory-fraction
   grid at N = 256, 300 steps, probes attached; each rank holds two.  The
   records (gathered once after the run), the whole final state and the
   probe rows equal the unsharded ensemble's bit for bit, and no collective
   runs during the steps.
2. `SimulationService(mesh=)`: 4 slots over a 64-neuron pool, 2 per rank,
   pinned traffic (8 sessions, probes) whose two evicted sessions are
   restored into the other rank's slots.  Both ranks log the unsharded
   service's events, no collective runs during the rounds, and every
   session's records, final state and probe rows equal its isolated run
   and the unsharded service's result.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import probes
from repro_torch.core.engine import PlasticityEngine
from repro_torch.core.ensemble import EnsembleEngine
from repro_torch.core.msp import MSPConfig
from repro_torch.core.traversal import FMMConfig
from repro_torch.launch import sweep
from repro_torch.launch.distributed import run_ranks
from repro_torch.launch.serve import ServiceJob, build_service, default_traffic, replay_traffic
from repro_torch.sharding import rules

N, K, STEPS, SEED = 256, 4, 300, 2
POOL, SLOTS, ROUND = 64, 4, 100
POS = np.random.default_rng(1).uniform(0, 1000.0, (N, 3)).astype(np.float32)
GRID = sweep.grid(sigma=[600.0, 750.0], inhibitory_fraction=[0.0, 0.2])
TRAFFIC = default_traffic(seed=5, num_sessions=8, pool_size=POOL, round_steps=ROUND,
                          max_rounds_of_work=3)


def _engine():
    return PlasticityEngine(POS, MSPConfig.calibrated(speedup=400.0),
                            FMMConfig(c1=8, c2=8, sigma=600.0), device="cpu")


def _pset(n):
    return probes.ProbeSet([probes.SpikeRasterProbe(), probes.CalciumProbe(),
                            probes.TurnoverProbe(np.arange(n) % 3, 3)], chunk_size=STEPS)


@dataclasses.dataclass
class EnsembleMeshJob:
    """K replicas with `EnsembleEngine(mesh=)` on this rank's ensemble group."""

    def run(self, groups, device) -> dict:
        from repro_torch.launch.mesh import CountingGroup
        group = CountingGroup(groups.ensemble)
        eng = _engine()
        ens = EnsembleEngine(eng, mesh=group)
        pset = _pset(N)
        st, recs, ps = ens.simulate(ens.init_states(K), STEPS, seed=SEED, probes=pset,
                                    params=sweep.pack_params(eng, GRID), gather=True)
        calls = {k: v["calls"] for k, v in group.counts.items()}
        whole_ps = rules.unshard_tree(rules.ensemble_spec(ps), ps, ensemble_group=group)
        return dict(calls=calls, records={f: v.numpy() for f, v in recs._asdict().items()},
                    state=convert.to_numpy(ens.gather_states(st)),
                    probe_state=convert.probe_state_to_numpy(whole_ps))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    pset = _pset(POOL)
    ens_res, svc_res = run_ranks(2, [EnsembleMeshJob(),
                                     ServiceJob(POOL, SLOTS, ROUND, TRAFFIC, str(ckpt),
                                                probes=pset)],
                                 "cpu", 240.0, 60.0, ensemble=2)
    return ens_res, svc_res


def test_ensemble_mesh_equals_the_unsharded_ensemble(runs):
    res, _ = runs
    eng = _engine()
    ens = EnsembleEngine(eng)
    pset = _pset(N)
    st, recs, ps = ens.simulate(ens.init_states(K), STEPS, seed=SEED, probes=pset,
                                params=sweep.pack_params(eng, GRID))
    for f, v in recs._asdict().items():
        np.testing.assert_array_equal(res["records"][f], v.numpy(), err_msg=f)
    for f, v in convert.to_numpy(st).items():
        np.testing.assert_array_equal(res["state"][f], v, err_msg=f)
    for name, buf in ps.buffers.items():
        np.testing.assert_array_equal(res["probe_state"]["buffers"][name], buf.numpy())
    # The records' one gather after the run; nothing during the steps.
    assert res["calls"] == {"gather": 1, "merge": 0, "scatter_sum": 0, "gather_objects": 0,
                            "gather_to_host": 0}
    assert (recs.num_synapses[-1] > 0).all()


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    svc = build_service(POOL, num_slots=SLOTS, round_steps=ROUND, speedup=400.0, seed=42,
                        checkpoint_dir=str(tmp_path_factory.mktemp("plain")),
                        probes=_pset(POOL), device="cpu")
    events = replay_traffic(svc, TRAFFIC)
    yield svc, events
    svc.close()


def test_service_mesh_restores_across_ranks_without_collectives(runs, unsharded):
    _, res = runs
    svc, events = unsharded
    assert res["events"] == events
    slot = {}
    crossed = 0
    for e in events:
        m = re.match(r"(admitted|restored) (\S+) slot=(\d+)", e)
        if m:
            crossed += m.group(1) == "restored" and slot[m.group(2)] // 2 != int(m.group(3)) // 2
            slot[m.group(2)] = int(m.group(3))
    assert crossed == 2
    assert all(c["calls"] == 0 for c in res["rounds_counts"].values())
    assert res["gather_counts"]["gather_objects"]["calls"] == 1


def test_every_served_session_equals_its_isolated_run(runs, unsharded):
    _, res = runs
    svc, _ = unsharded
    for _, req in TRAFFIC:
        got = res["results"][req.session_id]
        plain = svc.result(req.session_id)
        eng = svc.isolated_engine(req.n_neurons)
        st, recs, ps = eng.simulate(eng.init_state(), req.num_steps, seed=req.seed,
                                    probes=_pset(req.n_neurons))
        for f, v in recs._asdict().items():
            np.testing.assert_array_equal(got["records"][f], v.numpy(), err_msg=f)
            np.testing.assert_array_equal(got["records"][f], getattr(plain.records, f).numpy())
        want = {f: v for part in (plain.final_state.neurons, plain.final_state.edges)
                for f, v in part._asdict().items()}
        for f, v in want.items():
            np.testing.assert_array_equal(got["state"][f], v.numpy(), err_msg=f)
        assert torch.equal(plain.final_state.edges.valid[:st.edges.valid.shape[0]],
                           st.edges.valid)
        if req.record_probes:
            for name in ("spikes", "calcium"):
                np.testing.assert_array_equal(got["probe_rows"][name][:, :req.n_neurons],
                                              ps.buffers[name][:req.num_steps].numpy())
        else:
            assert got["probe_rows"] is None
