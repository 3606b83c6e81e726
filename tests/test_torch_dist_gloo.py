"""The port's distributed engine over gloo, in spawned CPU processes
(`repro_torch.launch.distributed.run_ranks`, a `file://` rendezvous under a
temporary directory, so parallel test workers cannot collide).

At N = 256, 300 steps from a fresh state, for p in {1, 2, 4} ranks, with
method="fmm" in every allowed combination of the three switches
(pyramid_partials x find_phase x pyramid_exchange) and with batched and
counter draws: records, spikes and the whole final state (edge tables
included) equal the single-device port run on the same Morton-sorted
positions bit for bit.  The routed exchange fetches every level below the
root (routed_shared_levels=0).  Each p also runs a forced deletion (an edge
table with excess on both sides), sharded and replicated.

Barnes-Hut runs the same matrix in tests/test_torch_dist_gloo_bh.py, and a
p = 4 run with the JAX engine's draws is held to the JAX engine in
tests/test_torch_dist_gloo_jax.py.
Every rank group has a 60 s collective timeout and a 240 s wall-clock
limit.
"""
import concurrent.futures

import numpy as np
import pytest

from repro_torch import convert
from repro_torch.core.distributed import sorted_positions
from repro_torch.core.engine import EngineConfig, PlasticityEngine
from repro_torch.core.msp import MSPConfig
from repro_torch.core.traversal import FMMConfig
from repro_torch.launch.distributed import Job, allowed_options, run_ranks, same_run

N, STEPS, SEED = 256, 300, 1
RANKS = (1, 2, 4)
MSP_CFG = MSPConfig.calibrated(speedup=400.0)
FMM_CFG = FMMConfig(c1=8, c2=8)
POS = np.random.default_rng(0).uniform(0, 1000.0, (N, 3)).astype(np.float32)
DELETION = "deletion"


def excess_state(engine_cfg: EngineConfig) -> dict:
    """A whole start state with about 5 valid edges per neuron against
    floor(elements) = 1: the first update must delete on both sides."""
    rng = np.random.default_rng(4)
    e = N * engine_cfg.edge_capacity_per_neuron
    return {"x": np.full(N, MSP_CFG.x0, np.float32), "refrac": np.zeros(N, np.int32),
            "spiked": np.zeros(N, bool), "calcium": np.full(N, 0.5, np.float32),
            "ax_elems": np.full(N, 1.7, np.float32), "den_elems": np.full(N, 1.7, np.float32),
            "src": rng.integers(0, N, e).astype(np.int32),
            "dst": rng.integers(0, N, e).astype(np.int32),
            "valid": rng.random(e) < 5 / engine_cfg.edge_capacity_per_neuron,
            "step": np.int32(0), "dropped": np.int32(0)}


def cases(method: str):
    """(label, Job) for every switch combination and draw mode, and the
    forced deletion through both find phases."""
    out = []
    for rng in ("batched", "counter"):
        ecfg = EngineConfig(method=method, rng=rng)
        for opts in allowed_options(method):
            label = f"{rng}-{opts['pyramid_partials']}-{opts['find_phase']}-" \
                    f"{opts['pyramid_exchange']}"
            if opts["pyramid_exchange"] == "routed":
                # At N = 256 the tree has depth 2: fetch every level below the root.
                opts = dict(opts, routed_shared_levels=0)
            out.append((label, Job(POS, MSP_CFG, FMM_CFG, ecfg, opts, STEPS, seed=SEED)))
    ecfg = EngineConfig(method=method, edge_capacity_per_neuron=8)
    for phase in ("sharded", "replicated"):
        out.append((f"{DELETION}-{phase}", Job(POS, MSP_CFG, FMM_CFG, ecfg,
                                               dict(find_phase=phase), 120, seed=SEED,
                                               state=excess_state(ecfg))))
    return out


def single_device(job: Job):
    eng = PlasticityEngine(sorted_positions(job.positions, job.engine_cfg), job.msp_cfg,
                           job.fmm_cfg, job.engine_cfg, device="cpu")
    st = (eng.init_state() if job.state is None
          else convert.from_jax_state(job.state, "cpu"))
    return eng.simulate(st, job.steps, seed=job.seed, noise=job.noise)


def run_matrix(method: str):
    """Every case on p = 1, 2 and 4 ranks (the three rank groups at once),
    and the single-device runs meanwhile."""
    labelled = cases(method)
    jobs = [job for _, job in labelled]
    with concurrent.futures.ThreadPoolExecutor(len(RANKS)) as pool:
        futures = {p: pool.submit(run_ranks, p, jobs, "cpu", 240.0, 60.0) for p in RANKS}
        refs = {label: single_device(job) for label, job in labelled}
        results = {p: f.result() for p, f in futures.items()}
    return {(p, label): (results[p][i], refs[label])
            for p in RANKS for i, (label, _) in enumerate(labelled)}


def check(res: dict, ref, label: str):
    st, recs = ref
    bad = same_run(res, st, recs)
    assert not bad, f"{label}: differs from the single-device run in {bad}"
    syn = recs.num_synapses.numpy()
    if label.startswith(DELETION):
        assert syn[98] > 4 * N and syn[99] < syn[98], "no deletions"
    else:
        assert syn[-1] > 0 and recs.spike_rate.numpy().sum() > 0


@pytest.fixture(scope="module")
def fmm_runs():
    return run_matrix("fmm")


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("label", [label for label, _ in cases("fmm")])
def test_fmm_equals_the_single_device_run(fmm_runs, p, label):
    check(*fmm_runs[(p, label)], label)


def test_collectives_per_activity_step(fmm_runs):
    """Between updates a step runs one merge (the synaptic input) and one
    gather (calcium and spikes), whatever p: 300 steps, 3 updates."""
    res, _ = fmm_runs[(4, "batched-owner_span-sharded-gathered")]
    c = res["counts"]
    assert c["gather"]["calls"] > STEPS and c["merge"]["calls"] > STEPS
    assert c["scatter_sum"]["calls"] == 0
    routed, _ = fmm_runs[(4, "batched-owner_span-sharded-routed")]
    assert routed["counts"]["scatter_sum"]["calls"] > 0
