"""The 2-D (ensemble x data) layout over gloo, in spawned CPU processes
(`repro_torch.launch.distributed.run_ranks(..., ensemble=e)`, a `file://`
rendezvous under a temporary directory, 60 s collective timeout).

At N = 256, K = 4 replicas of a sigma x inhibitory-fraction grid, 300
steps from a fresh state, on (e, d) in {(2, 1), (1, 2), (2, 2)}, with
method "fmm" and "barnes_hut" and with batched and counter draws, spike,
calcium and turnover probes attached: every replica's records, whole final
state (edge tables included) and probe rows, and the chunk files the ranks
write, equal the single-device `EnsembleEngine` run on the same
Morton-sorted positions bit for bit.  No collective is made on the ensemble
group during a run.  On (2, 2), a run of 150 steps saves a checkpoint of
its whole state and probe state; a second run restores it and takes 150
more steps, equal to the uninterrupted run, and the single-device ensemble
resumes from the same checkpoint to the same result.  On (1, 2) and (2, 2)
the save moves the parts to rank 0's host one at a time, none larger than
a rank's own, with no gather of the state, and a restored rank holds
storage for its own part only.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import probes
from repro_torch.core.distributed import sorted_positions
from repro_torch.core.engine import EngineConfig, PlasticityEngine
from repro_torch.core.ensemble import EnsembleEngine
from repro_torch.core.msp import MSPConfig
from repro_torch.core.traversal import FMMConfig
from repro_torch.launch import sweep
from repro_torch.launch.distributed import EnsembleJob, run_ranks, same_run

N, K, STEPS, SEED = 256, 4, 300, 1
LAYOUTS = ((2, 1), (1, 2), (2, 2))
CHECKPOINTED = ((1, 2), (2, 2))
MSP_CFG = MSPConfig.calibrated(speedup=400.0)
FMM_CFG = FMMConfig(c1=8, c2=8, sigma=600.0)
POS = np.random.default_rng(0).uniform(0, 1000.0, (N, 3)).astype(np.float32)
GRID = sweep.grid(sigma=[600.0, 750.0], inhibitory_fraction=[0.0, 0.2])
LABELS = [f"{m}-{r}" for m in ("fmm", "barnes_hut") for r in ("batched", "counter")]


def _pset():
    return probes.ProbeSet([probes.SpikeRasterProbe(), probes.CalciumProbe(),
                            probes.TurnoverProbe(np.arange(N) % 4, 4)], chunk_size=STEPS)


def _engine(label):
    method, rng = label.split("-")
    ecfg = EngineConfig(method=method, rng=rng)
    return PlasticityEngine(sorted_positions(POS, ecfg), MSP_CFG, FMM_CFG, ecfg, device="cpu")


def _params(eng):
    return convert.params_to_numpy(sweep.pack_params(eng, GRID))


def _jobs(root, layout):
    jobs = []
    for label in LABELS:
        eng = _engine(label)
        jobs.append(EnsembleJob(POS, MSP_CFG, FMM_CFG, eng.engine_cfg, {}, STEPS, K, seed=SEED,
                                params=_params(eng), probes=_pset(),
                                probe_dir=str(root / f"{layout}-{label}")))
    if layout in CHECKPOINTED:
        eng = _engine("fmm-batched")
        half = dict(params=_params(eng), probes=_pset(), seed=SEED)
        ck = str(root / ("checkpoint" if layout == (2, 2) else f"checkpoint-{layout}"))
        jobs += [EnsembleJob(POS, MSP_CFG, FMM_CFG, eng.engine_cfg, {}, STEPS // 2, K,
                             save_to=ck, **half),
                 EnsembleJob(POS, MSP_CFG, FMM_CFG, eng.engine_cfg, {}, STEPS // 2, K,
                             restore_from=ck, **half)]
    return jobs


def _single(label, root):
    eng = _engine(label)
    ens = EnsembleEngine(eng)
    pset = _pset()
    st, recs, ps = ens.simulate(ens.init_states(K), STEPS, seed=SEED,
                                params=convert.params_from_jax(_params(eng)), probes=pset)
    probes.ProbeWriter(str(root / f"single-{label}")).flush(pset, ps)
    return st, recs, ps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep2d")
    with concurrent.futures.ThreadPoolExecutor(len(LAYOUTS)) as pool:
        futures = {lay: pool.submit(run_ranks, lay[0] * lay[1], _jobs(root, lay), "cpu", 240.0,
                                    60.0, lay[0]) for lay in LAYOUTS}
        singles = {label: _single(label, root) for label in LABELS}
        results = {lay: f.result() for lay, f in futures.items()}
    return root, results, singles


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
@pytest.mark.parametrize("label", LABELS)
def test_every_replica_equals_the_single_device_run(runs, layout, label):
    root, results, singles = runs
    res = results[layout][LABELS.index(label)]
    st, recs, ps = singles[label]
    bad = same_run(res, st, recs)
    assert not bad, f"{layout} {label}: differs from the single-device run in {bad}"
    want = convert.probe_state_to_numpy(ps)
    for name, buf in want["buffers"].items():
        np.testing.assert_array_equal(res["probe_state"]["buffers"][name], buf, err_msg=name)
    np.testing.assert_array_equal(res["probe_state"]["cursor"], want["cursor"])
    assert (recs.num_synapses[-1] > 0).all() and int(ps.buffers["turnover"].sum()) > 0
    for r in range(K):
        for name in ("spikes", "calcium", "turnover"):
            a = probes.read_trajectory(str(root / f"{layout}-{label}"), name, replica=r)
            b = probes.read_trajectory(str(root / f"single-{label}"), name, replica=r)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=f"replica {r} {name}")


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_no_collective_on_the_ensemble_group(runs, layout):
    """The step loops make every collective on the data group; the ensemble
    group carries nothing during a run (the results are gathered after)."""
    _, results, _ = runs
    for res in results[layout]:
        assert all(c["calls"] == 0 for c in res["counts"]["ensemble"].values())
        data, steps = res["counts"]["data"], len(res["records"]["num_synapses"])
        assert data["gather"]["calls"] > steps and data["merge"]["calls"] > steps


def test_checkpoint_under_2x2_resumes_anywhere(runs):
    """150 + 150 steps through a checkpoint written under (2, 2) equal the
    300-step run, and the single-device ensemble resumes from the same
    checkpoint to the same records and state."""
    root, results, singles = runs
    first, second = results[(2, 2)][len(LABELS):]
    st, recs, ps = singles["fmm-batched"]
    whole = {f: np.concatenate([first["records"][f], second["records"][f]])
             for f in first["records"]}
    assert not same_run(dict(records=whole, state=second["state"]), st, recs)
    eng = _engine("fmm-batched")
    ens = EnsembleEngine(eng)
    pset = _pset()
    template = (ens.init_states(K), pset.init(N, batch=K, device="cpu"))
    (st0, ps0), step = CheckpointManager(str(root / "checkpoint")).restore(template)
    assert step == STEPS // 2 and st0.step == STEPS // 2
    st2, recs2, ps2 = ens.simulate(st0, STEPS // 2, seed=SEED, probe_states=ps0, probes=pset,
                                   params=convert.params_from_jax(_params(eng)))
    assert not same_run(dict(records=second["records"], state=second["state"]), st2, recs2)
    for name, buf in ps.buffers.items():
        assert torch.equal(ps2.buffers[name], buf), name


@pytest.mark.parametrize("layout", CHECKPOINTED, ids=lambda l: f"{l[0]}x{l[1]}")
def test_checkpoint_holds_one_part_per_device(runs, layout):
    """No card holds a whole checkpoint: saving makes no gather (all-gather)
    on either group, and rank 0 receives the parts one at a time, none
    larger than the largest part it holds itself, so its device holds its
    own part and one more; a restored rank's tensors own storage of their
    own size (no view into a whole-size template).  The resumed run equals
    the uninterrupted one."""
    _, results, singles = runs
    first, second = results[layout][len(LABELS):]
    saved = first["save_counts"]
    for group in ("data", "ensemble"):
        assert saved[group]["gather"]["calls"] == 0, group
    moved = [saved[g]["gather_to_host"] for g in ("data", "ensemble")
             if saved[g]["gather_to_host"]["calls"]]
    assert moved and max(m["largest"] for m in moved) <= first["part_bytes"]["largest"]
    held = second["restored_bytes"]
    assert held["storages"] == held["tensors"]
    assert held["tensors"] == first["part_bytes"]["tensors"]       # a part, not the whole
    st, recs, _ = singles["fmm-batched"]
    whole = {f: np.concatenate([first["records"][f], second["records"][f]])
             for f in first["records"]}
    assert not same_run(dict(records=whole, state=second["state"]), st, recs)
