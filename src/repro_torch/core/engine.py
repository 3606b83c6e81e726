"""PlasticityEngine: the full MSP simulation loop (port of
`repro/core/engine.py`, paper Sec. 3.1 + Sec. 4) on one device.

Per activity step (phases 1 and 2): synaptic input, Poisson spiking,
calcium and element growth.  Every `update_interval` steps (phase 3, the
connectivity update):

    1. delete excess synapses (elements < synapses), both sides;
    2. recompute vacancies;
    3. rebuild the octree aggregates (upward pass): the full pyramid for
       "fmm", only the dendrite counts and centroids for "barnes_hut", none
       for "direct";
    4. find partner requests: the FMM descent (`method="fmm"`), the
       per-neuron Barnes-Hut descent ("barnes_hut"), each followed by the
       leaf resolve, or the O(n^2) pairwise draw ("direct");
    5. dendrite-side conflict resolution;
    6. commit accepted synapses.

`simulate` is a host loop over `step`; the update runs when the advanced
step counter is a multiple of `update_interval`, as in the JAX engine.
Each layer runs inside a `torch.profiler.record_function` range (`step.*`,
`update.*`, `traversal.*`, `bh.descend`, `direct.find`), so a profile
attributes device time to layers.
Every random draw comes from a noise object (`core.noise`), by default the
generator-backed one seeded from `seed`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import device as _device
from repro_torch.core import barnes_hut, msp, octree, synapses, traversal
from repro_torch.core.msp import MSPConfig, NeuronState
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.synapses import SynapseState
from repro_torch.core.traversal import FMMConfig


class SimState(NamedTuple):
    neurons: NeuronState
    edges: SynapseState
    step: int                   # steps taken so far (host integer)
    dropped: torch.Tensor       # 0-d int64, edge-capacity overflow counter


class StepRecord(NamedTuple):
    """Per-step observables (paper Figs. 1 and 2); (steps,) each after
    `simulate`."""
    calcium_mean: torch.Tensor
    calcium_std: torch.Tensor
    num_synapses: torch.Tensor
    spike_rate: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    method: str = "fmm"                 # fmm | barnes_hut | direct
    edge_capacity_per_neuron: int = 64
    max_requests_per_neuron: int = 4    # unit-expansion bound per update
    domain: float = 1000.0              # cube side, micrometres
    depth: Optional[int] = None         # octree depth (None = auto)
    # Fraction of neurons whose outgoing synapses are inhibitory (signed
    # input); the paper's experiments are excitatory-only (0.0).
    inhibitory_fraction: float = 0.0
    pyramid: str = "segsum"             # segsum (m2m: ROADMAP Queue 1 item 5b)
    rng: str = "batched"                # batched (counter: ROADMAP Queue 1 item 10)

    def __post_init__(self):
        if self.method not in ("fmm", "barnes_hut", "direct"):
            raise ValueError(f"method must be one of 'fmm'/'barnes_hut'/'direct', "
                             f"got {self.method!r}")
        if self.pyramid not in ("segsum", "m2m"):
            raise ValueError(f"pyramid must be 'segsum' or 'm2m', got {self.pyramid!r}")
        if self.pyramid != "segsum":
            raise NotImplementedError(
                "pyramid='m2m' is not ported yet (ROADMAP.md Queue 1 item 5b)")
        if self.rng not in ("batched", "counter"):
            raise ValueError(f"rng must be 'batched' or 'counter', got {self.rng!r}")
        if self.rng != "batched":
            raise NotImplementedError(
                "rng='counter' is not ported yet; it comes with the serving "
                "slice (ROADMAP.md Queue 1 item 10)")


class PlasticityEngine:
    """Owns the static structure on its device; state flows through plain
    functions."""

    def __init__(self, positions: np.ndarray,
                 msp_cfg: MSPConfig = MSPConfig(),
                 fmm_cfg: FMMConfig = FMMConfig(),
                 engine_cfg: EngineConfig = EngineConfig(),
                 device: str | torch.device = "cuda"):
        self.device = _device.resolve(device)
        self.positions_np = np.asarray(positions, np.float32)
        self.n = self.positions_np.shape[0]
        self.msp_cfg = msp_cfg
        self.fmm_cfg = fmm_cfg
        self.engine_cfg = engine_cfg
        self.structure = octree.build_structure(
            self.positions_np, engine_cfg.domain, engine_cfg.depth)
        self.tree = octree.to_device(self.structure, self.device)
        self.positions = torch.as_tensor(self.positions_np, device=self.device)
        self.edge_capacity = engine_cfg.edge_capacity_per_neuron * self.n
        # Signed population vector (+1 excitatory / -1 inhibitory); the first
        # floor(f*n) neurons (in input order) are inhibitory.
        n_inh = int(engine_cfg.inhibitory_fraction * self.n)
        sign = np.ones((self.n,), np.float32)
        sign[:n_inh] = -1.0
        self.sign = torch.as_tensor(sign, device=self.device) if n_inh else None

    # -- state ------------------------------------------------------------
    def init_state(self) -> SimState:
        return SimState(neurons=msp.init_neurons(self.n, self.msp_cfg, self.device),
                        edges=synapses.empty(self.edge_capacity, self.device),
                        step=0,
                        dropped=torch.zeros((), dtype=torch.int64, device=self.device))

    # -- phase 3: connectivity update --------------------------------------
    def connectivity_update(self, state: SimState, noise, step: int) -> SimState:
        """The update with the draws of `step` (the step counter before the
        activity step that triggered it)."""
        n = self.n
        neurons = state.neurons
        with record_function("update.delete_excess"):
            edges = synapses.delete_excess(state.edges, neurons.ax_elems,
                                           neurons.den_elems, noise, step)
        with record_function("update.vacancies"):
            ax_vac = torch.clamp(torch.floor(neurons.ax_elems).to(torch.int32)
                                 - synapses.out_degree(edges, n), min=0).to(torch.float32)
            den_vac = torch.clamp(torch.floor(neurons.den_elems).to(torch.int32)
                                  - synapses.in_degree(edges, n), min=0).to(torch.float32)
        partner = self._find_partners(ax_vac, den_vac, noise, step)
        with record_function("update.conflicts_insert"):
            req_cnt = torch.clamp(ax_vac.to(torch.int32),
                                  max=self.engine_cfg.max_requests_per_neuron)
            req_cnt = torch.where(partner >= 0, req_cnt, 0)
            accepted = synapses.resolve_conflicts(partner, req_cnt,
                                                  den_vac.to(torch.int32),
                                                  noise.conflict_bits(step, n))
            edges, dropped = synapses.insert(edges, partner, accepted,
                                             self.engine_cfg.max_requests_per_neuron)
        return state._replace(edges=edges, dropped=state.dropped + dropped)

    def _find_partners(self, ax_vac, den_vac, noise, step: int) -> torch.Tensor:
        """(n,) int32 partner request per neuron (-1 = none), by the
        configured search method."""
        cfg = self.fmm_cfg
        method = self.engine_cfg.method
        if method == "direct":
            return barnes_hut.find_partners_direct(self.positions, ax_vac, den_vac,
                                                   cfg, noise, step)
        if method == "barnes_hut":
            with record_function("update.pyramid"):
                levels = octree.build_dendrite_pyramid(self.tree, self.positions, den_vac)
            return barnes_hut.find_partners_bh(self.tree, levels, self.positions, ax_vac,
                                               den_vac, cfg, noise, step)
        with record_function("update.pyramid"):
            levels = octree.build_pyramid(self.tree, self.positions, ax_vac, den_vac,
                                          cfg.delta, cfg.p)
        return traversal.find_partners(self.tree, levels, self.positions, ax_vac, den_vac,
                                       cfg, noise, step)

    # -- one simulation step -------------------------------------------------
    def step(self, state: SimState, noise) -> Tuple[SimState, StepRecord]:
        """One activity step (+ the periodic connectivity update)."""
        s = state.step
        with record_function("step.synaptic_input"):
            syn_in = synapses.synaptic_input(state.edges, state.neurons.spiked, self.sign)
        with record_function("step.neurons"):
            neurons = msp.step_neurons(state.neurons, syn_in, self.msp_cfg,
                                       u=noise.spike_uniform(s, self.n))
        state = state._replace(neurons=neurons, step=s + 1)
        if state.step % self.msp_cfg.update_interval == 0:
            state = self.connectivity_update(state, noise, s)
        # Order-fixed reductions (synapses.det_sum) times the reciprocal of
        # n, as the JAX engine computes its records.
        with record_function("step.records"):
            inv = float(np.float32(1.0) / np.float32(self.n))
            ca_mean = synapses.det_sum(neurons.calcium) * inv
            dev2 = (neurons.calcium - ca_mean) ** 2
            rec = StepRecord(
                calcium_mean=ca_mean,
                calcium_std=torch.sqrt(synapses.det_sum(dev2) * inv),
                num_synapses=state.edges.valid.sum(dtype=torch.int32),
                spike_rate=synapses.det_sum(neurons.spiked.to(torch.float32)) * inv)
        return state, rec

    # -- whole simulation -----------------------------------------------------
    def simulate(self, state: SimState, num_steps: int, seed: int = 0,
                 noise=None, params=None, n_active=None
                 ) -> Tuple[SimState, StepRecord]:
        """Run `num_steps` steps; returns (state, records stacked per step).

        noise: the draw source (default: `GeneratorNoise(seed)` on the
        engine's device).  params (KernelParams) and n_active belong to the
        ensemble and serving slices and are not ported yet."""
        if params is not None:
            raise NotImplementedError(
                "KernelParams (per-replica knobs) are not ported yet "
                "(ROADMAP.md Queue 1 item 8)")
        if n_active is not None:
            raise NotImplementedError(
                "n_active (padded subdomains) is not ported yet "
                "(ROADMAP.md Queue 1 item 10)")
        if noise is None:
            noise = GeneratorNoise(seed, self.device)
        recs = []
        for _ in range(num_steps):
            state, rec = self.step(state, noise)
            recs.append(rec)
        if not recs:
            empty = lambda dt: torch.zeros((0,), dtype=dt, device=self.device)
            return state, StepRecord(empty(torch.float32), empty(torch.float32),
                                     empty(torch.int32), empty(torch.float32))
        return state, StepRecord(*(torch.stack(f) for f in zip(*recs)))
