"""K independent replicas of one network, stepped as one batch (port of
`repro/core/ensemble.py`, single device).

Every state tensor gains a leading (K,) axis; the static structure
(positions, octree) is shared.  Each replica has its own noise object and
its own `KernelParams` row, so K differently parameterised brains run side
by side.  The semantics of the reference's `scan_replicas` hold:

  * each replica's draws come from its own stream, keyed by the shared step
    counter (replicas step in lockstep, so replica 0's counter stands for
    all, and a continuation draws what an uninterrupted run draws);
  * the update predicate is taken from that counter: all replicas update
    on the same steps.

The activity step is batched: one synaptic-input pass over the K edge
tables, one `msp_update` launch over K*n neurons and per-replica `det_sum`
records.  Every operation there is elementwise or an exact integer sum, so
each replica's rows are bit for bit its sequential run's.  The
connectivity update runs replica by replica through the engine's own
(ROADMAP.md Queue 1 item 8 lists a batched one as later work).

The serving hooks of the reference's `scan_replicas` (`extras`,
`fold_by_replica_step`, `do_update_fn`) are `step_slots`: K served slots,
each at its own step counter with its own session's counter draws, its own
active row count, and a hold for empty slots and sessions frozen at their
target step.  A device mesh over replicas belongs to ROADMAP.md Queue 1
item 11.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import noise as _noise, streams
from repro_torch.core.engine import (KernelParams, PlasticityEngine, SimState,
                                     activity_step, stack_records, step_records)
from repro_torch.core.msp import NeuronState
from repro_torch.core.synapses import SynapseState


def replica_noises(seed: int, num_replicas: int, device, rng: str = "batched") -> List:
    """One independent noise object per replica, seeded from `seed`, of the
    kind `EngineConfig.rng` names (`noise.for_config`)."""
    seeds = np.random.SeedSequence(seed).generate_state(num_replicas, np.uint32)
    return [_noise.for_config(rng, int(s), device) for s in seeds]


def replica(states: SimState, k: int) -> SimState:
    """Replica k of a (K,)-leading state (views, no copy).  The step is the
    shared counter, or slot k's of a (K,) numpy array of counters."""
    step = states.step
    return SimState(neurons=NeuronState(*(t[k] for t in states.neurons)),
                    edges=SynapseState(*(t[k] for t in states.edges)),
                    step=int(step[k]) if isinstance(step, np.ndarray) else step,
                    dropped=states.dropped[k])


def stack_states(parts: Sequence[SimState], per_replica_step: bool = False) -> SimState:
    """A (K,)-leading state from K replicas at the same step, or, with
    per_replica_step, each at its own (a (K,) int64 numpy array of counters,
    as served slots keep them)."""
    stack = lambda field: [torch.stack(ts) for ts in zip(*(getattr(p, field) for p in parts))]
    step = np.array([p.step for p in parts], np.int64) if per_replica_step else parts[0].step
    return SimState(neurons=NeuronState(*stack("neurons")), edges=SynapseState(*stack("edges")),
                    step=step, dropped=torch.stack([p.dropped for p in parts]))


def step_slots(engine: PlasticityEngine, states: SimState, noises: Sequence,
               keep: np.ndarray, n_active: np.ndarray, do_update: bool,
               signs: Optional[torch.Tensor] = None) -> tuple:
    """One step of K served slots of a padded pool (the serving hooks of the
    reference's `scan_replicas`).

    states:    (K,)-leading state of pool width; `step` is a (K,) int64
               numpy array, each slot's own counter.
    noises:    one `streams.CounterNoise` per slot, its session's; slot k
               draws at its own counter.
    keep:      (K,) bool: the slots that advance.  The others (empty slots,
               sessions frozen at their target step) are held: their rows
               still go through the batched launch, but their state and
               counter stay as they were, and they run no update.
    n_active:  (K,) ints: each slot's active row count (0 = empty).
    do_update: the connectivity-update predicate, from the round's step
               index: the service admits only at round boundaries and its
               rounds are whole update intervals, so every live counter is
               aligned with it.
    signs:     (K, n) sign vectors (`engine._runtime_sign` of each slot's
               n_active), or None when every slot is excitatory.

    The activity step is batched over all K x n rows; each live slot's
    update runs on its active prefix (`engine.connectivity_update`).
    Returns (states, records with (K,) fields)."""
    eng = engine
    dev = eng.device
    steps = states.step
    with record_function("slots.activity"):
        u = streams.spike_uniforms(noises, steps, eng.rows)
        mask = eng.rows < torch.as_tensor(n_active, device=dev).unsqueeze(-1)
        neurons = activity_step(states.neurons, states.edges, signs, u, eng.msp_cfg, mask)
        hold = torch.as_tensor(~keep, device=dev).unsqueeze(-1)
        neurons = NeuronState(*(torch.where(hold, old, new)
                                for new, old in zip(neurons, states.neurons)))
        states = states._replace(neurons=neurons)
    live = [k for k in range(len(keep)) if keep[k] and n_active[k] > 0]
    if do_update and live:
        with record_function("slots.update"):
            parts = [replica(states, k) for k in range(len(keep))]
            for k in live:
                parts[k] = eng.connectivity_update(parts[k], noises[k], parts[k].step,
                                                   n_active=int(n_active[k]))
            states = stack_states(parts, per_replica_step=True)
    states = states._replace(step=steps + keep.astype(np.int64))
    return states, step_records(neurons, states.edges, n_active)


class EnsembleEngine:
    """Runs K replicas of one `PlasticityEngine` as a batch."""

    def __init__(self, engine: PlasticityEngine, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a replica mesh (mesh=) is not ported yet (ROADMAP.md Queue 1 item 11)")
        self.engine = engine

    def init_states(self, num_replicas: int) -> SimState:
        """A fresh (K,)-leading state: the engine's initial state per replica."""
        return stack_states([self.engine.init_state()] * num_replicas)

    def default_params(self, num_replicas: int) -> KernelParams:
        """(K,) params equal to the engine's static configs (the identity sweep)."""
        base = KernelParams.from_configs(self.engine.fmm_cfg, self.engine.engine_cfg)
        return KernelParams(*(np.full((num_replicas,), v, np.float32) for v in base))

    def _signs(self, rows) -> Optional[torch.Tensor]:
        signs = [self.engine._runtime_sign(r) for r in rows]
        if all(s is None for s in signs):
            return None
        ones = torch.ones((self.engine.n,), dtype=torch.float32, device=self.engine.device)
        return torch.stack([ones if s is None else s for s in signs])

    def _step(self, states: SimState, noises, rows, signs) -> tuple:
        """One batched activity step, then every replica's connectivity
        update on the steps the shared counter schedules.  rows: each
        replica's `KernelParams` (or None); signs: their stacked sign
        vectors (`_signs`)."""
        eng = self.engine
        s = states.step
        u = torch.stack([nz.spike_uniform(s, eng.rows) for nz in noises])
        neurons = activity_step(states.neurons, states.edges, signs, u, eng.msp_cfg)
        states = states._replace(neurons=neurons, step=s + 1)
        if states.step % eng.msp_cfg.update_interval == 0:
            states = stack_states([
                eng.connectivity_update(replica(states, k), nz, s, rows[k])
                for k, nz in enumerate(noises)])
        return states, step_records(neurons, states.edges)

    def simulate(self, states: SimState, num_steps: int, seed: int = 0, noises=None,
                 params: Optional[KernelParams] = None, probes=None, probe_states=None):
        """Run all replicas `num_steps` steps.

        states: (K,)-leading state (`init_states`).  noises: one draw source
        per replica (default: `replica_noises(seed, K)` of the engine's rng).  params: (K,)
        columns (`launch.sweep.pack_params`; None = the static configs).
        probes: a `core.probes.ProbeSet`, recorded for every replica
        (probe_states: its (K,)-leading carry, None = fresh).
        Returns (states, records with (num_steps, K) fields), and the probe
        states as a third element when probes ride along."""
        k = states.dropped.shape[0]
        if noises is None:
            noises = replica_noises(seed, k, self.engine.device, self.engine.engine_cfg.rng)
        if len(noises) != k:
            raise ValueError(f"{len(noises)} noise objects for {k} replicas")
        rows = [None] * k if params is None else [params.row(r) for r in range(k)]
        signs = self._signs(rows)
        if probes is not None and probe_states is None:
            probe_states = probes.init(self.engine.n, start_step=states.step, batch=k,
                                       device=self.engine.device)
        recs = []
        for _ in range(num_steps):
            prev = states
            states, rec = self._step(states, noises, rows, signs)
            if probes is not None:
                probe_states = probes.record(probe_states, prev, states, rec)
            recs.append(rec)
        recs = stack_records(recs, self.engine.device)
        if probes is None:
            return states, recs
        return states, recs, probe_states
