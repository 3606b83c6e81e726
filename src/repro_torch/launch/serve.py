"""Launch helpers for the serving layer (port of `repro/launch/serve.py`):
build a service, replay traffic.

One place that knows how to wire a `SimulationService` from plain numbers
and drive a `TrafficGenerator` workload through it to completion.

    python -m repro_torch.launch.serve                 # the demo on the card
    python -m repro_torch.launch.serve --device cpu    # the same on the CPU

The demo replays a seeded TGI-style workload (staggered arrivals, ragged
budgets, idle gaps that evict and restore sessions) through 4 slots over a
96-neuron pool, then holds every session to an isolated run of its own
size, bit for bit.

`mesh=` spreads the slots over the ranks of an ensemble group; a
`ServiceJob` replays traffic so on spawned ranks
(`launch.distributed.run_ranks(..., ensemble=e)`).
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig
from repro_torch.core.msp import MSPConfig
from repro_torch.core.traversal import FMMConfig
from repro_torch.serve import SessionRequest, SimulationService, TrafficGenerator


def build_service(pool_size: int, *, num_slots: int, round_steps: int,
                  checkpoint_dir: Optional[str] = None, method: str = "fmm",
                  speedup: float = 100.0, sigma: float = 750.0, seed: int = 42,
                  inhibitory_fraction: float = 0.0, probes=None, mesh=None,
                  device: str | torch.device = "cuda") -> SimulationService:
    """A service over a uniform random position pool (the repo's standard
    synthetic geometry: positions ~ U[0, 1000)^3 from a seeded generator,
    calibrated MSP dynamics)."""
    rng = np.random.default_rng(seed)
    pool = rng.uniform(0.0, 1000.0, size=(pool_size, 3)).astype(np.float32)
    msp_cfg = MSPConfig.calibrated(speedup=speedup)
    fmm_cfg = FMMConfig(sigma=sigma)
    engine_cfg = EngineConfig(method=method, inhibitory_fraction=inhibitory_fraction)
    if checkpoint_dir is None:
        checkpoint_dir = tempfile.mkdtemp(prefix="repro_serve_")
    return SimulationService(pool, msp_cfg, fmm_cfg, engine_cfg, num_slots=num_slots,
                             round_steps=round_steps, checkpoint_dir=checkpoint_dir,
                             probes=probes, mesh=mesh, device=device)


def replay_traffic(service: SimulationService, traffic: List[Tuple[int, SessionRequest]],
                   max_rounds: int = 10_000, gather: bool = True) -> List[str]:
    """Feed [(arrival_round, request)] into the service, submitting each
    request at its arrival round, and run rounds until every session
    finishes; with a mesh and `gather`, then gather the results
    (`SimulationService.gather_results`: every rank replays the same
    traffic).  Returns the full event log."""
    pending = sorted(traffic, key=lambda t: t[0])
    events: List[str] = []
    i = 0
    for _ in range(max_rounds):
        while i < len(pending) and pending[i][0] <= service.round_idx:
            service.submit(pending[i][1])
            i += 1
        events.extend(service.run_round())
        if i == len(pending) and all(s.status == "finished"
                                     for s in service.sessions.values()):
            if gather:
                service.gather_results()
            return events
    raise RuntimeError(f"traffic did not drain in {max_rounds} rounds")


@dataclasses.dataclass
class ServiceJob:
    """A traffic replay through `build_service(pool_size, ...)` with mesh= on
    the ensemble group of a spawned layout (`launch.distributed.run_ranks`
    with ensemble=e, data=1); checkpoint_dir is shared by every rank."""
    pool_size: int
    num_slots: int
    round_steps: int
    traffic: list
    checkpoint_dir: str
    speedup: float = 400.0
    seed: int = 42
    probes: object = None

    def run(self, groups, device) -> dict:
        """Replay on this rank (collective); returns the events, every
        session's records, final state and probe rows (numpy), and the
        collective calls on the ensemble group during the rounds and in the
        gather of results."""
        from repro_torch.launch.mesh import CountingGroup
        mesh = CountingGroup(groups.ensemble)
        svc = build_service(self.pool_size, num_slots=self.num_slots,
                            round_steps=self.round_steps, checkpoint_dir=self.checkpoint_dir,
                            speedup=self.speedup, seed=self.seed, probes=self.probes,
                            mesh=mesh, device=device)
        events = replay_traffic(svc, self.traffic, gather=False)
        rounds_counts = {k: dict(v) for k, v in mesh.counts.items()}
        mesh.reset()
        svc.gather_results()
        results = {}
        for _, req in self.traffic:
            r = svc.result(req.session_id)
            results[req.session_id] = dict(
                records={f: v.numpy() for f, v in r.records._asdict().items()},
                state={f: v.numpy() for part in (r.final_state.neurons, r.final_state.edges)
                       for f, v in part._asdict().items()},
                probe_rows=None if r.probe_rows is None else
                {k: v.numpy() for k, v in r.probe_rows.items()})
        svc.close()
        return dict(events=events, results=results, rounds_counts=rounds_counts,
                    gather_counts={k: dict(v) for k, v in mesh.counts.items()})


def default_traffic(*, seed: int, num_sessions: int, pool_size: int, round_steps: int,
                    max_rounds_of_work: int = 4) -> List[Tuple[int, SessionRequest]]:
    """The harness's standard workload: sizes in [pool/3, pool], budgets up
    to `max_rounds_of_work` rounds with ragged tails, ~30% idle gaps."""
    gen = TrafficGenerator(seed=seed, num_sessions=num_sessions,
                           n_lo=max(8, pool_size // 3), n_hi=pool_size,
                           max_steps=max_rounds_of_work * round_steps,
                           step_quantum=round_steps)
    return gen.generate()


def occupancy_histogram(service: SimulationService) -> Dict[int, int]:
    """occupancy -> number of executed rounds at that occupancy."""
    hist: Dict[int, int] = {}
    for k in service.occupancy_log:
        hist[k] = hist.get(k, 0) + 1
    return hist


def main(argv: Optional[Sequence[str]] = None) -> None:
    """The demo (the port's counterpart of examples/serve_demo.py)."""
    from repro_torch.core.probes import CalciumProbe, ProbeSet, SpikeRasterProbe

    ap = argparse.ArgumentParser(description="continuous-batching service demo")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    pool, rounds_of_work = 96, 3
    with tempfile.TemporaryDirectory(prefix="serve_demo_") as ckpt:
        pset = ProbeSet([SpikeRasterProbe(), CalciumProbe()], chunk_size=rounds_of_work * 100)
        svc = build_service(pool, num_slots=4, round_steps=100, speedup=400.0, seed=42,
                            checkpoint_dir=ckpt, probes=pset, device=args.device)
        traffic = default_traffic(seed=6, num_sessions=8, pool_size=pool, round_steps=100,
                                  max_rounds_of_work=rounds_of_work)
        print(f"pool={pool} slots={svc.num_slots} sessions={len(traffic)}")
        for arrival, req in traffic:
            gap = f" idle_after={req.idle_after}" if req.idle_after else ""
            print(f"  round {arrival}: {req.session_id} n={req.n_neurons} "
                  f"steps={req.num_steps}{gap}")
        for e in replay_traffic(svc, traffic):
            print("  " + e)
        print("occupancy histogram:", occupancy_histogram(svc))
        print("verifying bit for bit against isolated runs...")
        for _, req in traffic:
            res = svc.result(req.session_id)
            eng = svc.isolated_engine(req.n_neurons)
            _, recs = eng.simulate(eng.init_state(), req.num_steps, seed=req.seed)
            for f, a, b in zip(recs._fields, res.records, recs):
                if not torch.equal(a, b.cpu()):
                    raise AssertionError(f"{req.session_id}: records.{f} diverged")
            probed = " +probes" if req.record_probes else ""
            print(f"  {req.session_id}: n={req.n_neurons} steps={req.num_steps} "
                  f"synapses={int(recs.num_synapses[-1])}{probed} OK")
        print("all sessions bit for bit identical to isolated runs")
        svc.close()
    dev = svc.device
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")


if __name__ == "__main__":
    main()
