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
(ROADMAP.md Queue 2, N4, lists a batched one as later work).

The serving hooks of the reference's `scan_replicas` (`extras`,
`fold_by_replica_step`, `do_update_fn`) are `step_slots`: K served slots,
each at its own step counter with its own session's counter draws, its own
active row count, and a hold for empty slots and sessions frozen at their
target step.

With `mesh=` (an ensemble group, `launch.mesh.make_ensemble_group`) each
of e ranks holds a block of K/e replicas and steps it with no collective:
replicas never communicate.  Noises and params stay global (K of each),
states are the rank's block (`init_states`, `shard_states`); the records
come back (T, K) in replica order only when the caller asks (`gather=`),
in one gather after the run, and `gather_states` puts the blocks together.
`DistributedEnsembleEngine` (core/distributed.py) cuts each replica's
neurons over a data group too.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import noise as _noise, streams
from repro_torch.core.engine import (KernelParams, PlasticityEngine, SimState, StepRecord,
                                     activity_step, stack_records, step_records)
from repro_torch.core.msp import NeuronState
from repro_torch.core.synapses import SynapseState
from repro_torch.sharding import rules


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


def stacked_signs(engine: PlasticityEngine, rows) -> Optional[torch.Tensor]:
    """(K, n) sign vectors of K replicas' `KernelParams` rows (or None each),
    or None when every replica is excitatory."""
    signs = [engine._runtime_sign(r) for r in rows]
    if all(s is None for s in signs):
        return None
    ones = torch.ones((engine.n,), dtype=torch.float32, device=engine.device)
    return torch.stack([ones if s is None else s for s in signs])


def check_ensemble_group(group) -> None:
    """Raise unless `group` is None or a group of the ensemble axis."""
    name = getattr(group, "name", None)
    if group is not None and name != rules.ENSEMBLE:
        raise ValueError(f"mesh has no {rules.ENSEMBLE!r} axis: got {type(group).__name__} "
                         f"named {name!r}")


def replica_block(group, num_replicas: int) -> tuple:
    """[lo, hi) of the replicas that ensemble coordinate `group.rank` holds
    (group None: all of them)."""
    if group is None:
        return 0, num_replicas
    if num_replicas % group.size:
        raise ValueError(f"the ensemble axis size {group.size} must divide the replica "
                         f"count {num_replicas}")
    return rules.rows_of(group.rank, group.size, num_replicas)


def gather_records(group, recs: StepRecord) -> StepRecord:
    """(T, K/e) records of every ensemble coordinate -> (T, K) in replica
    order, in one gather (every field travels as its int32 words: one for a
    float32, two for the distributed engine's int64 synapse count)."""
    if group is None:
        return recs
    words = [f.contiguous().view(torch.int32).reshape(f.shape + (-1,)) for f in recs]
    got = rules.gather_dim(group, torch.cat(words, dim=-1), 1)            # (T, K, words)
    out, at = [], 0
    for f, w in zip(recs, words):
        out.append(got[..., at:at + w.shape[-1]].contiguous().view(f.dtype)[..., 0])
        at += w.shape[-1]
    return StepRecord(*out)


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
    The records count the edge tables every call: the service rewrites slot
    states between rounds when it admits or evicts a session.
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
    """Runs K replicas of one `PlasticityEngine` as a batch.

    mesh: None (every replica here), or an ensemble group of e ranks
    (`launch.mesh.make_ensemble_group`): this rank holds replicas
    [c*K/e, (c+1)*K/e) of coordinate c = mesh.rank, and K % e == 0."""

    def __init__(self, engine: PlasticityEngine, mesh=None):
        check_ensemble_group(mesh)
        self.engine = engine
        self.mesh = mesh

    def init_states(self, num_replicas: int) -> SimState:
        """A fresh state of this rank's block of K replicas: the engine's
        initial state per replica."""
        lo, hi = replica_block(self.mesh, num_replicas)
        return stack_states([self.engine.init_state()] * (hi - lo))

    def shard_states(self, states: SimState) -> SimState:
        """This rank's block of a whole (K,)-leading state."""
        k = states.dropped.shape[0]
        replica_block(self.mesh, k)
        size, coord = (1, 0) if self.mesh is None else (self.mesh.size, self.mesh.rank)
        return rules.shard_tree(rules.ensemble_spec(states), states, coord=coord,
                                ensemble=size)

    def gather_states(self, states: SimState) -> SimState:
        """The whole (K,)-leading state from every rank's block (collective
        over the ensemble group, after a run)."""
        return rules.unshard_tree(rules.ensemble_spec(states), states, ensemble_group=self.mesh)

    def default_params(self, num_replicas: int) -> KernelParams:
        """(K,) params equal to the engine's static configs (the identity sweep)."""
        base = KernelParams.from_configs(self.engine.fmm_cfg, self.engine.engine_cfg)
        return KernelParams(*(np.full((num_replicas,), v, np.float32) for v in base))

    def _step(self, states: SimState, noises, rows, signs, num_synapses=None) -> tuple:
        """One batched activity step, then every replica's connectivity
        update on the steps the shared counter schedules.  rows: each
        replica's `KernelParams` (or None); signs: their stacked sign
        vectors (`stacked_signs`); num_synapses: the previous step's (K,)
        count of the same run, reused unless this step updates (None =
        count the tables); the record carries the count used.  The K
        draws run in the `step.draws` range, each update in its own
        `update.connectivity`, the stack of the updated replicas in
        `update.stack`."""
        eng = self.engine
        s = states.step
        with record_function("step.draws"):
            u = torch.stack([nz.spike_uniform(s, eng.rows) for nz in noises])
        neurons = activity_step(states.neurons, states.edges, signs, u, eng.msp_cfg)
        states = states._replace(neurons=neurons, step=s + 1)
        if states.step % eng.msp_cfg.update_interval == 0:
            parts = [eng.connectivity_update(replica(states, k), nz, s, rows[k])
                     for k, nz in enumerate(noises)]
            with record_function("update.stack"):
                states = stack_states(parts)
            del parts       # the K replicas' own tables, before the records' count
            num_synapses = None
        return states, step_records(neurons, states.edges, num_synapses=num_synapses)

    def simulate(self, states: SimState, num_steps: int, seed: int = 0, noises=None,
                 params: Optional[KernelParams] = None, probes=None, probe_states=None,
                 gather: bool = False):
        """Run all replicas `num_steps` steps.

        states: this rank's block of the (K,)-leading state (`init_states`).
        noises: one draw source per replica, all K (default:
        `replica_noises(seed, K)` of the engine's rng).  params: (K,) columns
        (`launch.sweep.pack_params`; None = the static configs).
        probes: a `core.probes.ProbeSet`, recorded for every replica
        (probe_states: its carry of this rank's block, None = fresh).
        gather: return the records of all K replicas (one gather over the
        mesh after the run) instead of this rank's block.
        Returns (states, records with (num_steps, K) fields), and the probe
        states as a third element when probes ride along.  The edge
        tables' synapse counts are taken on the first step and after each
        update, and carried over the steps between (only within this call:
        a caller may rewrite `states.edges` between calls)."""
        kb = states.dropped.shape[0]
        k = kb * (1 if self.mesh is None else self.mesh.size)
        lo, hi = replica_block(self.mesh, k)
        if noises is None:
            noises = replica_noises(seed, k, self.engine.device, self.engine.engine_cfg.rng)
        if len(noises) != k:
            raise ValueError(f"{len(noises)} noise objects for {k} replicas")
        noises = noises[lo:hi]
        rows = [None] * kb if params is None else [params.row(r) for r in range(lo, hi)]
        signs = stacked_signs(self.engine, rows)
        if probes is not None and probe_states is None:
            probe_states = probes.init(self.engine.n, start_step=states.step, batch=kb,
                                       device=self.engine.device)
        recs, nsyn = [], None
        for _ in range(num_steps):
            prev = states
            states, rec = self._step(states, noises, rows, signs, nsyn)
            nsyn = rec.num_synapses
            if probes is not None:
                probe_states = probes.record(probe_states, prev, states, rec)
            recs.append(rec)
        recs = stack_records(recs, self.engine.device)
        if gather:
            recs = gather_records(self.mesh, recs)
        if probes is None:
            return states, recs
        return states, recs, probe_states


# -- the contract auditor's registry (`repro_torch.audit`) ------------------------
AUDIT = {
    "entry_points": {
        "ensemble.simulate": {
            "rules": {
                "R1": {},
                # Replicas never communicate: no collective on any group.
                "R2": {"allowed_groups": ()},
                "R4": {"allowlist": (
                    ("repro_torch.core.synapses.synaptic_input",
                     "adds +1/-1 per spiking partner: integers, exact in float32 below 2^24"),
                )},
            },
        },
    },
}
