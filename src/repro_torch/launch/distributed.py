"""Run the distributed engines on the ranks of this host.

    python -m repro_torch.launch.distributed --ranks 4 --device cpu   # gloo, 1-D
    python -m repro_torch.launch.distributed --ensemble 2 --data 2 --device cpu
    python -m repro_torch.launch.distributed                          # NCCL, 1 rank

Each rank is a process started with the "spawn" method; the ranks meet
through a `file://` rendezvous in a temporary directory (no port to pick),
run a list of jobs in the same process group, and rank 0 writes each job's
result for the caller.  A `Job` runs `DistributedPlasticityEngine` on a
data group of every rank; with `ensemble=e`, the ranks form the 2-D layout
of e x (world/e) ranks (`launch.mesh.make_sweep_groups`), and a job is any
object with a `run(groups, device)` method, such as `EnsembleJob`
(`DistributedEnsembleEngine`) or `launch.serve.ServiceJob`; with
`lm=(data, model)`, the ranks form the LM layout
(`launch.mesh.make_host_mesh`) and a job's `run` gets its `LMGroups`
(`launch.lm_train.TrainJob`).

The 1-D demo runs N = 256 for 300 steps in every allowed combination of the
engine's switches and checks each run against the single-device engine on
the same Morton-sorted positions, bit for bit; the 2-D demo runs K = 4
replicas of a sigma x inhibitory-fraction grid, FMM and Barnes-Hut, batched
and counter draws, and checks every replica against the single-device
`EnsembleEngine` run.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import convert, device as _device
from repro_torch.core.engine import EngineConfig, PlasticityEngine
from repro_torch.core.msp import MSPConfig
from repro_torch.core.traversal import FMMConfig
from repro_torch.sharding import rules

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


@dataclasses.dataclass
class EnsembleJob:
    """One run of K replicas on the 2-D layout (`DistributedEnsembleEngine`).
    params: `KernelParams` columns by field name, or None for the static
    configs.  state: the whole (K,)-stacked start state as
    `convert.to_numpy` gives it (on the sorted positions), or None for a
    fresh one.  noises: K picklable noise objects (None =
    `replica_noises(seed, K)` of the engine's rng).  probes: a
    `core.probes.ProbeSet` recorded for every replica; probe_dir: where its
    chunk is flushed at the end (None = not written).  restore_from: a
    checkpoint directory whose latest whole (state[, probe state]) tree is
    the start (it overrides `state`); save_to: where the final tree is saved
    (`DistributedEnsembleEngine.save_checkpoint`)."""
    positions: np.ndarray
    msp_cfg: MSPConfig
    fmm_cfg: FMMConfig
    engine_cfg: EngineConfig
    options: Dict[str, object]
    steps: int
    replicas: int
    seed: int = 0
    params: Optional[dict] = None
    state: Optional[dict] = None
    noises: Optional[list] = None
    probes: object = None
    probe_dir: Optional[str] = None
    restore_from: Optional[str] = None
    save_to: Optional[str] = None

    def run(self, groups, device) -> dict:
        """Run on this rank of `groups` (collective); returns the records of
        every replica, the whole final state, the whole probe state, the
        collective counts of the run on the data and the ensemble group, and
        the chunk files this rank wrote."""
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.core.distributed import (DistributedEnsembleEngine,
                                                  DistributedPlasticityEngine)
        from repro_torch.core.ensemble import gather_records, replica_block
        from repro_torch.core.probes import ProbeWriter
        from repro_torch.launch.mesh import CountingGroup
        data, ens_group = CountingGroup(groups.data), CountingGroup(groups.ensemble)
        eng = DistributedPlasticityEngine(self.positions, data, self.msp_cfg, self.fmm_cfg,
                                          self.engine_cfg, device=device, **self.options)
        ens = DistributedEnsembleEngine(eng, ens_group)
        st = (ens.init_states(self.replicas) if self.state is None
              else ens.shard_states(convert.from_jax_state(self.state, device)))
        ps, res = None, dict(paths=None, probe_state=None)
        if self.restore_from is not None:
            st, *rest = ens.restore_checkpoint(CheckpointManager(self.restore_from,
                                                                 async_save=False),
                                               self.replicas, self.probes)
            ps = rest[0] if rest else None
            res["restored_bytes"] = held_bytes((st, ps))
        params = None if self.params is None else convert.params_from_jax(self.params)
        data.reset()
        ens_group.reset()
        out = ens.simulate(st, self.steps, seed=self.seed, noises=self.noises, params=params,
                           probes=self.probes, probe_states=ps)
        counts = lambda: {"data": {k: dict(v) for k, v in data.counts.items()},
                          "ensemble": {k: dict(v) for k, v in ens_group.counts.items()}}
        res["counts"] = counts()
        if self.save_to is not None:
            tree = (out[0], out[2] if self.probes is not None else None)
            data.reset()
            ens_group.reset()
            ens.save_checkpoint(CheckpointManager(self.save_to, async_save=False), out[0],
                                self.probes, tree[1])
            res["save_counts"], res["part_bytes"] = counts(), held_bytes(tree)
        if self.probes is not None:
            if self.probe_dir is not None:
                lo, _ = replica_block(groups.ensemble, self.replicas)
                res["paths"] = ProbeWriter(self.probe_dir).flush(
                    self.probes, out[2], group=groups.data, replica_offset=lo)
            res["probe_state"] = convert.probe_state_to_numpy(
                ens.gather_probe_states(self.probes, out[2]))
        recs = gather_records(groups.ensemble, out[1])
        res["records"] = {f: v.cpu().numpy() for f, v in recs._asdict().items()}
        res["state"] = convert.to_numpy(ens.gather_states(out[0]))
        return res


def held_bytes(tree) -> dict:
    """The tensors of a tree: the bytes they span ("tensors"), those of the
    storages behind them ("storages": more when one is a view into a larger
    one), and the largest one's ("largest")."""
    ts = []
    rules.tree_map(lambda x: ts.append(x) if isinstance(x, torch.Tensor) else None, tree)
    size = lambda t: t.numel() * t.element_size()
    return dict(tensors=sum(map(size, ts)),
                storages=sum(t.untyped_storage().nbytes() for t in ts),
                largest=max(map(size, ts)))


def rank_device(device: str, rank: int) -> str:
    """The device of rank `rank` when the ranks run on `device`: card r
    ("cuda:<r>") for the card, the CPU for "cpu"."""
    kind = torch.device(device).type
    return f"cuda:{rank}" if kind == "cuda" else kind


def _rank_main(rank: int, world: int, init_file: str, jobs: Sequence, out_dir: str,
               device: str, collective_timeout_s: float, ensemble: Optional[int],
               lm: Optional[Tuple[int, int]] = None) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_data_group, make_host_mesh, make_sweep_groups
    device = rank_device(device, rank)
    if device == "cpu":
        torch.set_num_threads(1)        # p processes share the host's cores
    init = f"file://{init_file}"
    groups = None
    if lm is not None:
        groups = make_host_mesh(*lm, init, rank, device, collective_timeout_s)
    elif ensemble is None:
        group = make_data_group(init, rank, world, device, collective_timeout_s)
    else:
        groups = make_sweep_groups(ensemble, world // ensemble, init, rank, device,
                                   collective_timeout_s)
    try:
        for i, job in enumerate(jobs):
            res = run_job(group, job, device) if groups is None else job.run(groups, device)
            if rank == 0:
                torch.save(res, os.path.join(out_dir, f"{i}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, jobs: Sequence, device: str = "cuda", timeout_s: float = 300.0,
              collective_timeout_s: float = 60.0, ensemble: Optional[int] = None,
              lm: Optional[Tuple[int, int]] = None) -> List[dict]:
    """Run `jobs` on `world` spawned ranks; returns rank 0's result of each.
    ensemble None: every job a `Job` on a data group of all ranks
    (`run_job`); ensemble=e: the 2-D layout of e x (world/e) ranks, each job
    run by `job.run(groups, device)`; lm=(data, model): the LM layout of
    data x model ranks, each job run by `job.run(layout, device)`.  Raises
    if a rank fails (a collective that waits longer than
    collective_timeout_s fails it), and stops every rank and raises if they
    are not done within timeout_s.  Runs on the card unless device="cpu"
    (gloo) is asked for; on the card, rank r runs on card r (`rank_device`),
    and fewer cards than ranks is an error before any rank is spawned."""
    dev = _device.resolve(device)
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards, one a rank; "
                           f"{torch.cuda.device_count()} visible")
    if ensemble is not None and world % ensemble:
        raise ValueError(f"the ensemble axis size {ensemble} must divide the world size {world}")
    if lm is not None and lm[0] * lm[1] != world:
        raise ValueError(f"the LM layout {lm[0]} x {lm[1]} needs {lm[0] * lm[1]} ranks, "
                         f"not {world}")
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_dist_") as tmp:
        init = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init, list(jobs), tmp, device,
                                   collective_timeout_s, ensemble, lm))
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


def demo_ensemble(ensemble: int, data: int, device: str) -> None:
    """The 2-D demo: K = 4 replicas of a sigma x inhibitory-fraction grid on
    e x d ranks, FMM and Barnes-Hut, batched and counter draws, each against
    the single-device `EnsembleEngine` run on the sorted positions."""
    from repro_torch.core.distributed import sorted_positions
    from repro_torch.core.ensemble import EnsembleEngine
    from repro_torch.launch import sweep
    pos = np.random.default_rng(0).uniform(0, 1000.0, (256, 3)).astype(np.float32)
    msp_cfg, fmm_cfg = MSPConfig.calibrated(speedup=400.0), FMMConfig(c1=8, c2=8, sigma=600.0)
    grid = sweep.grid(sigma=[600.0, 750.0], inhibitory_fraction=[0.0, 0.2])
    jobs = []
    for method, rng in itertools.product(("fmm", "barnes_hut"), ("batched", "counter")):
        ecfg = EngineConfig(method=method, rng=rng)
        eng = PlasticityEngine(sorted_positions(pos, ecfg), msp_cfg, fmm_cfg, ecfg, device="cpu")
        params = convert.params_to_numpy(sweep.pack_params(eng, grid))
        jobs.append(EnsembleJob(pos, msp_cfg, fmm_cfg, ecfg, {}, DEMO_STEPS, len(grid), seed=1,
                                params=params))
    t = time.perf_counter()
    results = run_ranks(ensemble * data, jobs, device, ensemble=ensemble)
    print(f"{len(jobs)} runs of K = {len(grid)} replicas on {ensemble} x {data} ranks "
          f"({device}) in {time.perf_counter() - t:.1f} s")
    for job, res in zip(jobs, results):
        eng = PlasticityEngine(sorted_positions(pos, job.engine_cfg), msp_cfg, fmm_cfg,
                               job.engine_cfg, device=device)
        ens = EnsembleEngine(eng)
        st, recs = ens.simulate(ens.init_states(job.replicas), DEMO_STEPS, seed=1,
                                params=convert.params_from_jax(job.params))
        bad = same_run(res, st, recs)
        print(f"  {job.engine_cfg.method} {job.engine_cfg.rng}: synapses "
              f"{res['records']['num_synapses'][-1].tolist()}, collectives on the ensemble "
              f"group during the run {sum(c['calls'] for c in res['counts']['ensemble'].values())}"
              f", {'bit for bit equal' if not bad else 'DIFFERS in ' + ', '.join(bad)}")
        if bad:
            raise SystemExit(1)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="distributed engine demo")
    ap.add_argument("--ranks", type=int, default=1, help="ranks of the 1-D demo")
    ap.add_argument("--ensemble", type=int, default=None,
                    help="ensemble axis size: run the 2-D demo on ensemble x data ranks")
    ap.add_argument("--data", type=int, default=1, help="data axis size of the 2-D demo")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, default) or cpu (gloo)")
    args = ap.parse_args(argv)
    if args.ensemble is not None:
        demo_ensemble(args.ensemble, args.data, args.device)
        return
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
