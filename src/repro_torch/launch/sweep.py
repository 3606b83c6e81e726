"""Parameter sweeps over the ensemble (port of `repro/launch/sweep.py`).

Builds config grids, packs them into `KernelParams` columns, runs every
combination as one batch of replicas (`core.ensemble.EnsembleEngine`) and
reduces each replica's `StepRecord` trajectory to a summary row:

    configs = sweep.grid(sigma=[600, 750], inhibitory_fraction=[0.0, 0.2])
    engine  = PlasticityEngine(positions, msp_cfg, FMMConfig(sigma=600), engine_cfg)
    result  = sweep.run_sweep(engine, configs, num_steps=20_000, seed=0)
    for row in sweep.summarize(result):
        print(row)

The sweepable knobs are the fields of `KernelParams`.  Seed ensembles come
from `replicates > 1`: each config repeated with its own noise stream.  The
expansion-validity guard reads the engine's STATIC sigma, so build the
engine with the sweep's smallest sigma; `run_sweep` warns when it is not.

`mesh=` spreads the replicas over processes (`make_ensemble`): an ensemble
group (`launch.mesh.make_ensemble_group`) gives each rank a block of
replicas, the 2-D groups of `launch.mesh.make_sweep_groups` also cut each
replica's neurons over a data group.

    python -m repro_torch.launch.sweep                 # the 2x2 demo on the card
    python -m repro_torch.launch.sweep --device cpu    # the same on the CPU
"""
from __future__ import annotations

import argparse
import itertools
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import KernelParams, PlasticityEngine, SimState, StepRecord
from repro_torch.core.ensemble import EnsembleEngine, replica_noises

SWEEPABLE = ("sigma", "c1", "c2", "inhibitory_fraction")


def grid(**axes: Sequence[float]) -> List[Dict[str, float]]:
    """Cartesian product of named value lists -> list of config dicts, in
    SWEEPABLE's order.  Omitted knobs take the engine's static configs when
    packed."""
    unknown = set(axes) - set(SWEEPABLE)
    if unknown:
        raise ValueError(f"unknown sweep axes {sorted(unknown)}; sweepable: {SWEEPABLE}")
    names = [n for n in SWEEPABLE if n in axes]
    return [dict(zip(names, map(float, vals)))
            for vals in itertools.product(*(axes[n] for n in names))]


def pack_params(engine: PlasticityEngine, configs: Sequence[Dict[str, float]]) -> KernelParams:
    """(K,) float32 KernelParams columns from config dicts (missing keys =
    the engine's static configs)."""
    defaults = {"sigma": engine.fmm_cfg.sigma, "c1": engine.fmm_cfg.c1,
                "c2": engine.fmm_cfg.c2,
                "inhibitory_fraction": engine.engine_cfg.inhibitory_fraction}
    col = lambda name: np.asarray([cfg.get(name, defaults[name]) for cfg in configs],
                                  np.float32)
    return KernelParams(sigma=col("sigma"), c1=col("c1"), c2=col("c2"),
                        inhibitory_fraction=col("inhibitory_fraction"))


def _unwrapped(group):
    while hasattr(group, "inner"):          # a CountingGroup
        group = group.inner
    return group


def make_ensemble(engine: PlasticityEngine, mesh=None):
    """The ensemble engine for `mesh`:

    None                -> `EnsembleEngine` (every replica here);
    an ensemble group   -> `EnsembleEngine(mesh=)`, a block of replicas per rank;
    `SweepGroups` (2-D) -> `DistributedEnsembleEngine`: a plain engine is
                           rewrapped into a `DistributedPlasticityEngine` on the
                           data group with its default switches (owner_span /
                           sharded / gathered); it re-sorts the neurons by
                           Morton code, so edge ids of the states refer to its
                           `positions_np`.  A `DistributedPlasticityEngine`
                           built on the layout's data group passes through
                           with its own switches.

    A `DistributedPlasticityEngine` built on other groups raises."""
    from repro_torch.core.distributed import (DistributedEnsembleEngine,
                                              DistributedPlasticityEngine)
    from repro_torch.launch.mesh import SweepGroups
    if isinstance(engine, DistributedPlasticityEngine):
        if not isinstance(mesh, SweepGroups) or (_unwrapped(engine.group)
                                                 is not _unwrapped(mesh.data)):
            raise ValueError("engine was built on other groups than the layout's data group; "
                             "rebuild the DistributedPlasticityEngine on it")
        return DistributedEnsembleEngine(engine, mesh.ensemble)
    if isinstance(mesh, SweepGroups):
        deng = DistributedPlasticityEngine(engine.positions_np, mesh.data, engine.msp_cfg,
                                           engine.fmm_cfg, engine.engine_cfg,
                                           device=engine.device)
        return DistributedEnsembleEngine(deng, mesh.ensemble)
    return EnsembleEngine(engine, mesh=mesh)


class SweepResult(NamedTuple):
    configs: List[Dict[str, float]]   # K config dicts (replicates expanded)
    states: SimState                  # final (K, ...) states
    records: StepRecord               # (num_steps, K) trajectories
    calcium_end: np.ndarray           # (K,) mean calcium over the tail window
    synapses_end: np.ndarray          # (K,) synapse count at the last step
    spike_rate: np.ndarray            # (K,) mean spike rate over the tail
    probe_states: Optional[object] = None   # final (K,)-leading ProbeState, if probed


def run_sweep(engine: PlasticityEngine, configs: Sequence[Dict[str, float]],
              num_steps: int, seed: int = 0, replicates: int = 1, mesh=None,
              tail: int = 500, probes=None, noises=None) -> SweepResult:
    """Run every config (x replicates) as one batch from the engine's initial
    state; reduce the trajectories over the last `tail` steps.

    noises: one draw source per replica (default: `replica_noises(seed, K)`,
    so replicate r of config c has its own stream).  probes: a
    `core.probes.ProbeSet` recorded per replica; its final buffers come back
    as `SweepResult.probe_states`.  mesh: see `make_ensemble` (collective:
    every rank of the layout calls it); the records and the states come back
    whole on every rank, the probe states as this rank's part."""
    swept_sigmas = [c.get("sigma", engine.fmm_cfg.sigma) for c in configs]
    if engine.fmm_cfg.sigma > min(swept_sigmas):
        warnings.warn(
            "engine's static sigma exceeds the sweep minimum: the expansion "
            "validity guard may admit boxes too large for the smallest "
            "sigma's kernel; construct the engine with sigma="
            f"{min(swept_sigmas)} for a conservative guard.")
    expanded = [c for c in configs for _ in range(replicates)]
    k = len(expanded)
    ens = make_ensemble(engine, mesh)
    if noises is None:
        noises = replica_noises(seed, k, engine.device)
    out = ens.simulate(ens.init_states(k), num_steps, noises=noises,
                       params=pack_params(engine, expanded), probes=probes, gather=True)
    states, recs = ens.gather_states(out[0]), out[1]
    t = min(tail, num_steps)
    ca = recs.calcium_mean.cpu().numpy()
    syn = recs.num_synapses.cpu().numpy()
    rate = recs.spike_rate.cpu().numpy()
    return SweepResult(configs=expanded, states=states, records=recs,
                       calcium_end=ca[-t:].mean(axis=0), synapses_end=syn[-1],
                       spike_rate=rate[-t:].mean(axis=0),
                       probe_states=out[2] if probes is not None else None)


def summarize(result: SweepResult) -> List[Dict[str, float]]:
    """One row per replica: the swept knobs and the reduced observables."""
    dropped = result.states.dropped.cpu().numpy()
    rows = []
    for r, cfg in enumerate(result.configs):
        row = dict(cfg)
        row.update(replica=r, calcium_end=float(result.calcium_end[r]),
                   synapses_end=int(result.synapses_end[r]),
                   spike_rate=float(result.spike_rate[r]), dropped=int(dropped[r]))
        rows.append(row)
    return rows


def main(argv: Optional[Sequence[str]] = None, num_steps: int = 4000) -> None:
    """The demo: a 2x2 sigma x inhibitory_fraction grid at small scale."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.msp import MSPConfig
    from repro_torch.core.traversal import FMMConfig

    ap = argparse.ArgumentParser(description="2x2 parameter sweep demo")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    positions = rng.uniform(0, 1000.0, (300, 3)).astype(np.float32)
    configs = grid(sigma=[400.0, 750.0], inhibitory_fraction=[0.0, 0.2])
    engine = PlasticityEngine(positions, MSPConfig.calibrated(speedup=100.0),
                              FMMConfig(c1=8, c2=8, sigma=400.0),   # sweep-min sigma (guard)
                              EngineConfig(method="fmm"), device=args.device)
    result = run_sweep(engine, configs, num_steps=num_steps, seed=0)
    print(f"{'sigma':>7} {'inh_frac':>9} {'calcium':>8} {'synapses':>9} {'rate':>7}")
    for row in summarize(result):
        print(f"{row['sigma']:7.0f} {row['inhibitory_fraction']:9.2f} "
              f"{row['calcium_end']:8.3f} {row['synapses_end']:9d} {row['spike_rate']:7.4f}")
    dev = engine.device
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")


if __name__ == "__main__":
    main()
