"""The system under test: the port's ensemble engine, built from a
configuration file, and what the harness reads back from its state.

Only this module (and the profiler's ranges, read by name) touches the
program, `repro_torch`.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from bench.harness import traffic as tr
from repro_torch.core import noise
from repro_torch.core.engine import EngineConfig, PlasticityEngine
from repro_torch.core.ensemble import EnsembleEngine
from repro_torch.core.msp import MSPConfig
from repro_torch.core.traversal import FMMConfig
from repro_torch.launch import sweep


class System(NamedTuple):
    engine: object        # repro_torch.core.engine.PlasticityEngine
    ensemble: object      # repro_torch.core.ensemble.EnsembleEngine
    params: object        # (K,) KernelParams columns
    num_replicas: int
    device: torch.device


def build(config: dict, traffic: dict, positions: np.ndarray, device) -> System:
    """The engine of the configuration over `positions`, and the ensemble
    of the mix's replica grid."""
    msp = MSPConfig(**{f.name: config[f.name] for f in dataclasses.fields(MSPConfig)})
    fmm = FMMConfig(sigma=config["sigma"], p=config["p"], c1=config["c1"], c2=config["c2"],
                    size_guard=config["fmm"]["size_guard"])
    e = config["engine"]
    eng_cfg = EngineConfig(method=e["method"], domain=config["domain"],
                           edge_capacity_per_neuron=e["edge_capacity_per_neuron"],
                           max_requests_per_neuron=e["max_requests_per_neuron"],
                           pyramid=e["pyramid"], rng=e["rng"])
    eng = PlasticityEngine(positions, msp, fmm, eng_cfg, device)
    points = tr.grid(traffic)
    return System(engine=eng, ensemble=EnsembleEngine(eng),
                  params=sweep.pack_params(eng, points), num_replicas=len(points),
                  device=eng.device)


def noises(sys_: System, seed: int, episode: int) -> List:
    """Each replica's draw source for one episode, of the configuration's kind."""
    rng = sys_.engine.engine_cfg.rng
    return [noise.for_config(rng, tr.noise_seed(seed, episode, k), sys_.device)
            for k in range(sys_.num_replicas)]


def start_states(sys_: System, start: tr.Start):
    """The (K,)-leading start state: the engine's initial state with the
    drawn fields and synapses (in the first slots of every replica's
    table), the same in every replica, step 0."""
    states = sys_.ensemble.init_states(sys_.num_replicas)
    k, e = sys_.num_replicas, start.src.shape[0]
    drawn = {name: v.expand(k, -1).contiguous() for name, v in start.fields.items()}
    edges = states.edges
    if e > edges.valid.shape[-1]:
        raise ValueError(f"the start's {e} synapses exceed the edge table's "
                         f"{edges.valid.shape[-1]} slots")
    edges.src[:, :e] = start.src
    edges.dst[:, :e] = start.dst
    edges.valid[:, :e] = True
    return states._replace(neurons=states.neurons._replace(**drawn))


def run(sys_: System, states, num_steps: int, noises_: List):
    """`num_steps` steps of every replica: (states, records (T, K))."""
    return sys_.ensemble.simulate(states, num_steps, noises=noises_, params=sys_.params)


class Capture(NamedTuple):
    """One replica's state, copied to the host: the neuron fields, and the
    occupied slots of its edge table with their ids."""
    neurons: dict         # field -> (n,) numpy
    slots: np.ndarray     # (S,) int64
    src: np.ndarray       # (S,) int32
    dst: np.ndarray       # (S,) int32
    dropped: int


def capture(states, k: int) -> Capture:
    nrn = {f: getattr(states.neurons, f)[k].cpu().numpy() for f in states.neurons._fields}
    valid = states.edges.valid[k]
    slots = torch.nonzero(valid).squeeze(1)
    return Capture(neurons=nrn, slots=slots.cpu().numpy(),
                   src=states.edges.src[k][slots].cpu().numpy(),
                   dst=states.edges.dst[k][slots].cpu().numpy(),
                   dropped=int(states.dropped[k]))


def replica_records(recs, k: int) -> np.ndarray:
    """(T, 4) float64 of replica k's records (calcium mean and std, synapses,
    spike rate), exact for each float32 and int32 value."""
    return np.stack([f[:, k].double().cpu().numpy() for f in recs], axis=1)
