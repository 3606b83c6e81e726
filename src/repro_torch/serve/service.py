"""Simulation-as-a-service: continuous batching over slots (port of
`repro/serve/service.py`).

`SimulationService` turns the single-brain engine into a multi-tenant
server, the way TGI-style LLM servers turn one transformer into a token
service: K *slots* share one batched step (`core.ensemble.step_slots`),
and live sessions are packed into slots as they arrive, evicted to
checkpoints when idle, and restored, possibly into other slots, when they
wake up.

Three mechanisms make heterogeneous sessions batchable bit for bit
(DESIGN.md §14):

  * **Padded subdomains**: every slot holds the service's whole position
    pool (n_pool rows), but a session of n neurons runs with n_active = n:
    rows past n are made inert after every activity step and count in no
    record, and the slot's connectivity update runs on its active prefix
    (`PlasticityEngine.connectivity_update(n_active=)`).  So a session's
    records, edge table and probe rows equal an isolated
    `PlasticityEngine(pool[:n])` run's.
  * **Counter-mode draws** (`EngineConfig.rng="counter"`, core/streams.py):
    every draw is keyed by its logical index, so the streams do not depend
    on the pool's width.  Each slot draws with its session's seed at its
    own step counter.
  * **Round-based scheduling**: all slots step `round_steps` at a time,
    `round_steps` a multiple of `update_interval`, and sessions are
    admitted or restored only at round boundaries, so every live slot's
    counter is aligned with the round's step index and one predicate from
    that index schedules every slot's update.  A session whose budget ends
    mid-round is held at its target step (state, counter and probe rows)
    until the round's harvest.

The batched activity step launches `msp_update` once over K x n_pool rows
whatever the occupancy; the updates run slot by slot.  An evicted
session's checkpoint holds its own rows only: the state an isolated engine
of its size holds, and the probe rows recorded so far (the reference saves
the slot's whole width and probe chunk).  Profiler ranges: `serve.round`,
`serve.admit`, `serve.evict`, `serve.restore` (and `slots.activity`,
`slots.update` inside the step).

The host-side bookkeeping (who is in which slot) lives in
serve/batcher.SlotBatcher, whose invariants are tested on their own.

With `mesh=` (an ensemble group of e ranks, `launch.mesh.make_ensemble_group`)
the K slots are cut into e blocks of K/e.  Every rank runs the same
deterministic schedule (the same batcher, fed the same submissions), and
each steps, evicts, restores and harvests only the slots of its block: no
collective runs during the rounds.  A session evicted on one rank may be
restored on another, which reads the checkpoint the first wrote (so
`checkpoint_dir` must be seen by every rank) once it is published.  The
sessions' results are gathered to every rank at the end
(`gather_results`, one gather of host objects).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import device as _device
from repro_torch.checkpoint.manager import CheckpointManager, latest_step
from repro_torch.core import msp, synapses
from repro_torch.core.engine import EngineConfig, PlasticityEngine, SimState, StepRecord
from repro_torch.core.ensemble import check_ensemble_group, replica, stack_states, step_slots
from repro_torch.core.msp import MSPConfig, NeuronState
from repro_torch.core.probes import ProbeState
from repro_torch.core.streams import CounterNoise
from repro_torch.core.synapses import SynapseState
from repro_torch.core.traversal import FMMConfig
from repro_torch.serve import session as sess
from repro_torch.serve.batcher import SlotBatcher
from repro_torch.sharding import rules


# How long a restore waits for a checkpoint that another rank of the mesh
# writes (its eviction and the restore have no collective between them).
CHECKPOINT_WAIT_S = 120.0


class SlotExtras(NamedTuple):
    """Per-slot host integers the served step reads.

    n_active: (K,) int64: the occupant session's network size (0 = empty
              slot; the whole slot is then inert).
    target:   (K,) int64: the step count at which the occupant's budget
              ends; the slot is held once its counter reaches it.
    """
    n_active: np.ndarray
    target: np.ndarray


@dataclasses.dataclass
class SessionResult:
    """Everything a finished session's client gets back (host tensors)."""
    records: StepRecord  # (num_steps,) per field
    final_state: SimState  # full slot width
    probe_rows: Optional[Dict[str, torch.Tensor]]  # name -> (num_steps, ...)
    n_neurons: int


def _holds_rows(s: sess.Session) -> bool:
    """Live, evicted, or queued for a restore: the session will update
    again."""
    return s.status in (sess.RUNNING, sess.EVICTED) or (
        s.status == sess.QUEUED and s.steps_done > 0)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that later writes to the slot cannot reach (on the CPU,
    `.cpu()` would return the slot's own tensor)."""
    return t.to("cpu", copy=True)


def _to_host(state: SimState) -> SimState:
    cpu = lambda ts: type(ts)(*(_host(t) for t in ts))
    return SimState(neurons=cpu(state.neurons), edges=cpu(state.edges), step=int(state.step),
                    dropped=_host(state.dropped))


class SimulationService:
    """Session-managed, continuously batched simulation server.

    positions_pool: (n_pool, 3) float32, the shared position pool.  A
        session of size n simulates positions_pool[:n]; its isolated
        reference is `isolated_engine(n)`, with the SAME configs (the
        pool-resolved octree depth and counter draws included).
    num_slots:   K, the replica-axis width of the batched step.
    round_steps: steps per round; a positive multiple of
        msp_cfg.update_interval (module docs).
    checkpoint_dir: root of the per-session eviction checkpoints.
    probes: optional `core.probes.ProbeSet` recorded for the sessions that
        ask for it (`record_probes`); chunk_size must cover their budgets.
    mesh: None, or an ensemble group of e ranks over the slots (module
        docs); num_slots % e == 0.  Every rank must submit the same requests
        at the same rounds.
    device: "cuda" (default) or "cpu".
    """

    def __init__(self, positions_pool, msp_cfg: MSPConfig, fmm_cfg: FMMConfig,
                 engine_cfg: Optional[EngineConfig] = None, *, num_slots: int,
                 round_steps: int, checkpoint_dir: str, probes=None, mesh=None,
                 device: str | torch.device = "cuda"):
        check_ensemble_group(mesh)
        if mesh is not None and num_slots % mesh.size:
            raise ValueError(f"num_slots={num_slots} must divide over {mesh.size} devices")
        if round_steps <= 0 or round_steps % msp_cfg.update_interval != 0:
            raise ValueError(f"round_steps={round_steps} must be a positive multiple of "
                             f"update_interval={msp_cfg.update_interval}")
        self.device = _device.resolve(device)
        self.pool = np.asarray(positions_pool, np.float32)
        # Counter draws are what make a slot's streams independent of the
        # pool's width; the service serves with nothing else.
        base_cfg = dataclasses.replace(engine_cfg or EngineConfig(), rng="counter")
        self.engine = PlasticityEngine(self.pool, msp_cfg, fmm_cfg, base_cfg, self.device)
        # The depth is resolved once, from the pool: auto depth is a function
        # of n, and a session must see the same tree geometry in its slot
        # and in its isolated reference engine.
        self.engine_cfg = dataclasses.replace(base_cfg, depth=self.engine.structure.depth)
        self.msp_cfg = msp_cfg
        self.fmm_cfg = fmm_cfg
        self.num_slots = int(num_slots)
        self.round_steps = int(round_steps)
        self.checkpoint_dir = checkpoint_dir
        self.probes = probes
        self.mesh = mesh
        # This rank's block of slots, [slot_lo, slot_lo + K).
        self.slot_lo, hi = (0, self.num_slots) if mesh is None else rules.rows_of(
            mesh.rank, mesh.size, self.num_slots)

        self.batcher = SlotBatcher(self.num_slots)
        self.sessions: Dict[str, sess.Session] = {}
        self.round_idx = 0
        self.occupancy_log: List[int] = []  # live slots per executed round
        self._chunk_starts: Dict[str, List[int]] = {}   # first step of each record chunk
        self._gathered: set = set()                      # sessions whose results are whole

        K = hi - self.slot_lo
        self.states: SimState = stack_states([self.engine.init_state()] * K,
                                             per_replica_step=True)
        self.extras = SlotExtras(n_active=np.zeros((K,), np.int64),
                                 target=np.zeros((K,), np.int64))
        self.noises: List[CounterNoise] = [CounterNoise(0, self.device)] * K
        self._signs: List[Optional[torch.Tensor]] = [None] * K
        self._records_probes = np.zeros((K,), bool)
        self.probe_states = (probes.init(self.engine.n, batch=K, device=self.device)
                             if probes is not None else None)
        self._managers: Dict[str, CheckpointManager] = {}

    # -- slot plumbing -------------------------------------------------------
    def _local(self, slot: int) -> Optional[int]:
        """The slot's index in this rank's block, or None if another rank
        holds it."""
        i = slot - self.slot_lo
        return i if 0 <= i < self.extras.n_active.shape[0] else None

    def _write_slot(self, slot: int, state: SimState, seed: int, n_active: int,
                    target: int, probe: Optional[ProbeState] = None,
                    records_probes: bool = False):
        """Put a session's own rows (n_active neurons, its prefix of the edge
        table) into the slot (an index of this rank's block); the rest of
        the slot is zero."""
        cap = n_active * self.engine_cfg.edge_capacity_per_neuron
        for dst, src in zip(self.states.neurons, state.neurons):
            dst[slot].zero_()
            dst[slot, :n_active] = src
        for dst, src in zip(self.states.edges, state.edges):
            dst[slot].zero_()
            dst[slot, :cap] = src
        self.states.step[slot] = state.step
        self.states.dropped[slot] = state.dropped
        self.extras.n_active[slot] = n_active
        self.extras.target[slot] = target
        self.noises[slot] = CounterNoise(seed, self.device)
        self._signs[slot] = self.engine._runtime_sign(None, n_active) if n_active else None
        self._records_probes[slot] = records_probes
        if self.probes is not None:
            ps = self.probe_states
            rows = 0 if probe is None else int(probe.cursor)
            for p in self.probes.probes:
                buf = ps.buffers[p.name][slot]
                buf.zero_()
                if rows:
                    src = probe.buffers[p.name]
                    (buf[:rows, :n_active] if p.row_sharded else buf[:rows])[...] = src
            ps.cursor[slot] = rows
            ps.step0[slot] = state.step + 1 - rows

    def _clear_slot(self, slot: int):
        """Empty the slot if this rank holds it."""
        i = self._local(slot)
        if i is not None:
            self._write_slot(i, self._session_init(0), 0, 0, 0)

    def _session_init(self, n: int, device=None) -> SimState:
        """A fresh state of a session's own size n (the isolated engine's
        `init_state`)."""
        dev = self.device if device is None else device
        return SimState(neurons=msp.init_neurons(n, self.msp_cfg, dev),
                        edges=synapses.empty(n * self.engine_cfg.edge_capacity_per_neuron, dev),
                        step=0, dropped=torch.zeros((), dtype=torch.int64, device=dev))

    def _session_rows(self, slot: int, n: int):
        """The slot's (an index of this rank's block) state and probe carry
        cut to its session's own rows (views): what a checkpoint holds."""
        st = replica(self.states, slot)
        cap = n * self.engine_cfg.edge_capacity_per_neuron
        st = st._replace(neurons=NeuronState(*(t[:n] for t in st.neurons)),
                         edges=SynapseState(*(t[:cap] for t in st.edges)))
        if self.probes is None:
            return st, None
        ps = self.probe_states
        rows = int(ps.cursor[slot])
        bufs = {p.name: (ps.buffers[p.name][slot, :rows, :n] if p.row_sharded
                         else ps.buffers[p.name][slot, :rows]) for p in self.probes.probes}
        return st, ProbeState(cursor=np.array(rows, np.int32),
                              step0=np.array(ps.step0[slot], np.int32), buffers=bufs)

    def _manager(self, session_id: str) -> CheckpointManager:
        if session_id not in self._managers:
            self._managers[session_id] = CheckpointManager(
                os.path.join(self.checkpoint_dir, session_id), keep=2,
                async_save=False)  # durable BEFORE the slot is reused (I2)
        return self._managers[session_id]

    def _ckpt_tree(self, state, probe):
        tree = {"state": state}
        if self.probes is not None:
            tree["probe"] = probe
        return tree

    # -- client API ----------------------------------------------------------
    def submit(self, request: sess.SessionRequest) -> str:
        if request.session_id in self.sessions:
            raise ValueError(f"duplicate session id {request.session_id}")
        if request.n_neurons > self.engine.n:
            raise ValueError(f"n_neurons={request.n_neurons} exceeds the pool size "
                             f"{self.engine.n}")
        if request.record_probes:
            if self.probes is None:
                raise ValueError("service has no probe set configured")
            if request.num_steps > self.probes.chunk_size:
                raise ValueError(f"num_steps={request.num_steps} exceeds probe "
                                 f"chunk_size={self.probes.chunk_size}")
        self.sessions[request.session_id] = sess.Session(request=request)
        self.batcher.enqueue(request.session_id)
        return request.session_id

    def isolated_engine(self, n_neurons: int) -> PlasticityEngine:
        """The reference engine a session's results must equal bit for bit:
        the pool prefix of its size with the SAME configs (pool-resolved
        depth, counter draws), built anew."""
        return PlasticityEngine(self.pool[:n_neurons], self.msp_cfg, self.fmm_cfg,
                                self.engine_cfg, self.device)

    # -- scheduling ----------------------------------------------------------
    def _requeue_awake(self):
        for s in self.sessions.values():
            if (s.status == sess.EVICTED and s.idled and self.round_idx >= s.idle_until_round
                    and s.remaining > 0):
                self.batcher.enqueue(s.request.session_id, restore=True)
                s.status = sess.QUEUED

    def _restore(self, sid: str, s: sess.Session, slot: int):
        """Load the evicted session's rows from its checkpoint into `slot` (an
        index of this rank's block), once the checkpoint is published (another
        rank of the mesh may be writing it)."""
        req = s.request
        directory = os.path.join(self.checkpoint_dir, sid)
        deadline = time.monotonic() + CHECKPOINT_WAIT_S
        while (latest_step(directory) or 0) < s.steps_done:
            if time.monotonic() > deadline:
                raise TimeoutError(f"no checkpoint of {sid} at step {s.steps_done} in "
                                   f"{directory} after {CHECKPOINT_WAIT_S} s")
            time.sleep(0.01)
        n, cpu = req.n_neurons, torch.device("cpu")
        probe = None
        if self.probes is not None:
            rows = s.steps_done if req.record_probes else 0
            bufs = {}
            for p in self.probes.probes:
                shape, dtype = p.row_struct(n)
                bufs[p.name] = torch.empty((rows,) + tuple(shape), dtype=dtype)
            probe = ProbeState(cursor=np.zeros((), np.int32), step0=np.zeros((), np.int32),
                               buffers=bufs)
        tree, step = self._manager(sid).restore(
            self._ckpt_tree(self._session_init(n, cpu), probe))
        assert step == s.steps_done and tree["state"].step == s.steps_done
        self._write_slot(slot, tree["state"], req.seed, n, req.num_steps, tree.get("probe"),
                         req.record_probes)

    def _evict(self, sid: str, s: sess.Session, slot: int):
        """Checkpoint the session's rows (durable before the slot is freed;
        by the rank that holds the slot) and free its slot."""
        i = self._local(slot)
        if i is not None:
            state, probe = self._session_rows(i, s.request.n_neurons)
            self._manager(sid).save(self._ckpt_tree(state, probe), s.steps_done)
        self.batcher.release(sid, finished=False)
        self._clear_slot(slot)

    def _admit(self, events: List[str]):
        while (slot_assignment := self.batcher.admit_next()) is not None:
            sid, slot, is_restore = slot_assignment
            s = self.sessions[sid]
            req = s.request
            i = self._local(slot)
            if is_restore:
                if i is not None:
                    with record_function("serve.restore"):
                        self._restore(sid, s, i)
                events.append(f"restored {sid} slot={slot} step={s.steps_done}")
            else:
                if i is not None:
                    self._write_slot(i, self._session_init(req.n_neurons), req.seed,
                                     req.n_neurons, req.num_steps, None, req.record_probes)
                events.append(f"admitted {sid} slot={slot} n={req.n_neurons} "
                              f"steps={req.num_steps}")
            s.status = sess.RUNNING
            s.slot = slot

    def _step_round(self) -> StepRecord:
        """`round_steps` batched steps; returns the records, (R, K) fields."""
        interval = self.msp_cfg.update_interval
        ex = self.extras
        signs = None
        if any(sg is not None for sg in self._signs):
            ones = torch.ones((self.engine.n,), dtype=torch.float32, device=self.device)
            signs = torch.stack([ones if sg is None else sg for sg in self._signs])
        recs = []
        for i in range(self.round_steps):
            keep = self.states.step < ex.target       # held: empty, or at the target
            prev = self.states
            self.states, rec = step_slots(self.engine, self.states, self.noises, keep,
                                          ex.n_active, (i + 1) % interval == 0, signs)
            if self.probes is not None:
                self.probe_states = self.probes.record(self.probe_states, prev, self.states,
                                                       rec, keep=keep & self._records_probes)
            recs.append(rec)
        return StepRecord(*(torch.stack(f).cpu() for f in zip(*recs)))

    def _harvest_round(self, recs: StepRecord, events: List[str]):
        boundary = []
        for sid, slot in self.batcher.live_items():
            s = self.sessions[sid]
            took = min(self.round_steps, s.remaining)
            i = self._local(slot)
            if i is not None:
                s.record_chunks.append(StepRecord(*(f[:took, i] for f in recs)))
                self._chunk_starts.setdefault(sid, []).append(s.steps_done)
            s.steps_done += took
            boundary.append((sid, slot, s))
        for sid, slot, s in boundary:
            req = s.request
            if s.remaining == 0:
                self._finish(s, slot)
                self.batcher.release(sid, finished=True)
                self._clear_slot(slot)
                events.append(f"finished {sid} step={s.steps_done}")
            elif req.idle_after is not None and not s.idled and s.steps_done >= req.idle_after:
                with record_function("serve.evict"):
                    self._evict(sid, s, slot)
                s.status = sess.EVICTED
                s.slot = None
                s.idled = True
                s.idle_until_round = self.round_idx + 1 + req.idle_rounds
                events.append(f"evicted {sid} step={s.steps_done} "
                              f"until_round={s.idle_until_round}")

    def _finish(self, s: sess.Session, slot: int):
        s.status = sess.FINISHED
        s.slot = None
        # The engine caches one prefix engine per session size; keep it only
        # while a live or evicted session of that size may update again.
        n = s.request.n_neurons
        if not any(o.request.n_neurons == n and _holds_rows(o) for o in self.sessions.values()):
            self.engine.drop_prefix(n)
        i = self._local(slot)
        if i is None:               # another rank holds the slot: see gather_results
            return
        s.final_state = _to_host(replica(self.states, i))
        if self.probes is not None and s.request.record_probes:
            rows = s.steps_done
            s.probe_rows = {name: _host(buf[i, :rows])
                            for name, buf in self.probe_states.buffers.items()}
        else:
            s.probe_rows = None

    def run_round(self) -> List[str]:
        """One scheduling round: wake -> admit -> step R -> harvest."""
        events: List[str] = []
        with record_function("serve.round"):
            self._requeue_awake()
            with record_function("serve.admit"):
                self._admit(events)
            if self.batcher.live > 0:
                self.occupancy_log.append(self.batcher.live)
                self._harvest_round(self._step_round(), events)
        self.round_idx += 1
        return events

    def run_to_completion(self, max_rounds: int = 10_000) -> List[str]:
        """Rounds until every submitted session is FINISHED."""
        events: List[str] = []
        for _ in range(max_rounds):
            if all(s.status == sess.FINISHED for s in self.sessions.values()):
                self.gather_results()
                return events
            events.extend(self.run_round())
        raise RuntimeError(
            f"sessions still unfinished after {max_rounds} rounds: "
            f"{[sid for sid, s in self.sessions.items() if s.status != sess.FINISHED]}")

    # -- results -------------------------------------------------------------
    def gather_results(self) -> None:
        """With a mesh, give every rank every finished session's records,
        final state and probe rows (collective: every rank of the mesh calls
        it, after the same rounds).  A session's record chunks may come from
        several ranks, if it was restored into another rank's slot; they are
        put in step order.  Without a mesh there is nothing to do."""
        if self.mesh is None:
            return
        done = [sid for sid, s in self.sessions.items()
                if s.status == sess.FINISHED and sid not in self._gathered]
        mine = {sid: dict(chunks=list(zip(self._chunk_starts.get(sid, []),
                                          self.sessions[sid].record_chunks)),
                          final_state=self.sessions[sid].final_state,
                          probe_rows=self.sessions[sid].probe_rows) for sid in done}
        parts = self.mesh.gather_objects(mine)
        self._gathered.update(done)
        for sid in done:
            s = self.sessions[sid]
            chunks = sorted((c for part in parts for c in part.get(sid, {}).get("chunks", ())),
                            key=lambda c: c[0])
            self._chunk_starts[sid] = [c[0] for c in chunks]
            s.record_chunks = [c[1] for c in chunks]
            owner = [p[sid] for p in parts if sid in p and p[sid]["final_state"] is not None]
            s.final_state, s.probe_rows = owner[0]["final_state"], owner[0]["probe_rows"]

    def result(self, session_id: str) -> SessionResult:
        if session_id not in self.sessions:
            raise KeyError(f"unknown session id {session_id!r}")
        s = self.sessions[session_id]
        if s.status != sess.FINISHED:
            raise RuntimeError(f"{session_id} is {s.status}, not finished")
        records = StepRecord(*(torch.cat(chunks) for chunks in zip(*s.record_chunks)))
        return SessionResult(records=records, final_state=s.final_state,
                             probe_rows=s.probe_rows, n_neurons=s.request.n_neurons)

    def close(self):
        for mgr in self._managers.values():
            mgr.close()
        self._managers.clear()
        self.engine.drop_prefix()


# -- the contract auditor's registry (`repro_torch.audit`) ------------------------
AUDIT = {
    "entry_points": {
        "serve.round": {
            "rules": {
                "R1": {},
                # Slots never communicate, with or without a mesh.
                "R2": {"allowed_groups": ()},
                "R4": {"allowlist": (
                    ("repro_torch.core.synapses.synaptic_input",
                     "adds +1/-1 per spiking partner: integers, exact in float32 below 2^24"),
                )},
            },
        },
    },
}
