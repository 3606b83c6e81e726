"""Run `DistributedPlasticityEngine` on p ranks of this host.

    python -m repro_torch.launch.distributed --ranks 4 --device cpu   # gloo
    python -m repro_torch.launch.distributed                          # NCCL, 1 rank

Each rank is a process started with the "spawn" method; the ranks meet
through a `file://` rendezvous in a temporary directory (no port to pick),
run a list of jobs in the same process group, and rank 0 writes each job's
records, whole final state and collective counts for the caller.  The
demo runs N = 256 for 300 steps in every allowed combination of the
engine's switches and checks each run against the single-device engine on
the same Morton-sorted positions, bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.engine import EngineConfig, PlasticityEngine
from repro_torch.core.msp import MSPConfig
from repro_torch.core.traversal import FMMConfig

DEMO_STEPS = 300


@dataclasses.dataclass
class Job:
    """One distributed run.  state: the whole start state as
    `convert.to_numpy` gives it (on the sorted positions), or None for a
    fresh one.  noise: a picklable noise object every rank draws from
    (None = `EngineConfig.rng` seeded from `seed`)."""
    positions: np.ndarray
    msp_cfg: MSPConfig
    fmm_cfg: FMMConfig
    engine_cfg: EngineConfig
    options: Dict[str, object]
    steps: int
    seed: int = 0
    state: Optional[dict] = None
    noise: object = None


def allowed_options(method: str) -> List[Dict[str, str]]:
    """Every allowed combination of the three switches for `method`."""
    out = []
    for partials, phase, exchange in itertools.product(
            ("owner_span", "masked"), ("sharded", "replicated"), ("gathered", "routed")):
        if exchange == "routed" and (method != "fmm" or phase != "sharded"
                                     or partials != "owner_span"):
            continue
        out.append(dict(pyramid_partials=partials, find_phase=phase, pyramid_exchange=exchange))
    return out


def run_job(group, job: Job, device) -> dict:
    """Run `job` on this rank of `group` (collective); returns the records,
    the whole final state and the collective counts of the run."""
    from repro_torch.core.distributed import DistributedPlasticityEngine
    from repro_torch.launch.mesh import CountingGroup
    counting = CountingGroup(group)
    eng = DistributedPlasticityEngine(job.positions, counting, job.msp_cfg, job.fmm_cfg,
                                      job.engine_cfg, device=device, **job.options)
    st = (eng.init_state() if job.state is None
          else eng.shard_state(convert.from_jax_state(job.state, device)))
    counting.reset()
    st, recs = eng.simulate(st, job.steps, seed=job.seed, noise=job.noise)
    counts = {k: dict(v) for k, v in counting.counts.items()}
    whole = eng.gather_state(st)
    return dict(records={f: v.cpu().numpy() for f, v in recs._asdict().items()},
                state=convert.to_numpy(whole), counts=counts)


def _rank_main(rank: int, world: int, init_file: str, jobs: Sequence[Job], out_dir: str,
               device: str, collective_timeout_s: float) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_data_group
    if device == "cpu":
        torch.set_num_threads(1)        # p processes share the host's cores
    group = make_data_group(f"file://{init_file}", rank, world, device, collective_timeout_s)
    try:
        for i, job in enumerate(jobs):
            res = run_job(group, job, device)
            if rank == 0:
                torch.save(res, os.path.join(out_dir, f"{i}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, jobs: Sequence[Job], device: str = "cpu", timeout_s: float = 300.0,
              collective_timeout_s: float = 60.0) -> List[dict]:
    """Run `jobs` on `world` spawned ranks; returns rank 0's result of each
    (`run_job`).  Raises if a rank fails (a collective that waits longer
    than collective_timeout_s fails it), and stops every rank and raises if
    they are not done within timeout_s."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_dist_") as tmp:
        init = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init, list(jobs), tmp, device,
                                   collective_timeout_s))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            late = [p for p in procs if p.is_alive()]
            for p in late:
                p.terminate()
            for p in late:
                p.join(10.0)
        if late:
            raise TimeoutError(f"{len(late)} of {world} ranks still running after {timeout_s} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with codes {codes}")
        return [torch.load(os.path.join(tmp, f"{i}.pt"), weights_only=False)
                for i in range(len(jobs))]


def same_run(res: dict, st, recs) -> List[str]:
    """The fields in which a distributed result differs from a single-device
    run (state, records) on the same sorted positions: [] when they are
    equal bit for bit."""
    want = convert.to_numpy(st)
    bad = [f"records.{f}" for f, v in recs._asdict().items()
           if not np.array_equal(res["records"][f], v.cpu().numpy())]
    return bad + [f for f in want if not np.array_equal(res["state"][f], want[f])]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="distributed engine demo")
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, default) or cpu (gloo)")
    args = ap.parse_args(argv)
    from repro_torch.core.distributed import sorted_positions
    pos = np.random.default_rng(0).uniform(0, 1000.0, (256, 3)).astype(np.float32)
    msp_cfg, fmm_cfg = MSPConfig.calibrated(speedup=400.0), FMMConfig(c1=8, c2=8)
    jobs = []
    for method, rng in itertools.product(("fmm", "barnes_hut"), ("batched", "counter")):
        ecfg = EngineConfig(method=method, rng=rng)
        for opts in allowed_options(method):
            if opts["pyramid_exchange"] == "routed":
                opts = dict(opts, routed_shared_levels=0)   # fetch every level below the root
            jobs.append(Job(pos, msp_cfg, fmm_cfg, ecfg, opts, DEMO_STEPS, seed=1))
    t = time.perf_counter()
    results = run_ranks(args.ranks, jobs, args.device)
    print(f"{len(jobs)} runs on {args.ranks} ranks ({args.device}) in "
          f"{time.perf_counter() - t:.1f} s")
    for job, res in zip(jobs, results):
        eng = PlasticityEngine(sorted_positions(pos, job.engine_cfg), msp_cfg, fmm_cfg,
                               job.engine_cfg, device=args.device)
        st, recs = eng.simulate(eng.init_state(), DEMO_STEPS, seed=1)
        bad = same_run(res, st, recs)
        print(f"  {job.engine_cfg.method} {job.engine_cfg.rng} {job.options}: synapses "
              f"{int(res['records']['num_synapses'][-1])}, "
              f"{'bit for bit equal' if not bad else 'DIFFERS in ' + ', '.join(bad)}")
        if bad:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
