"""Probes: pure observers of the simulation loop (port of
`repro/core/probes.py`; the on-disk format is docs/probes.md's).

Probes record per-step observables that `StepRecord` does not hold: spike
rasters, per-neuron calcium, per-region synapse turnover.  Each probe writes
one row per step into a preallocated (chunk_size, *row) buffer on the
state's device at the carried cursor; `simulate_chunked` cuts a run at the
chunk boundaries, flushes each full chunk to disk (`ProbeWriter`) and resets
the cursor, so a trajectory of any length needs bounded device memory.

Purity (DESIGN.md §12): probes only read the states a step produced, and
the step never writes into a state tensor, so a probed run is bit for bit a
probe-free run.  The buffers themselves are written in place, a row at a
time (a functional update would copy the chunk every step): a `ProbeState`
shares its buffers with the states that `record` returns from it, and only
the rows below its cursor are its own.

`ProbeState.cursor` and `step0` are host numpy int32 arrays, () for one
run and (K,) for an ensemble, as the JAX package's are; every buffer then
carries the same leading (K,) axis.  Chunk files are named by their first
recorded step, so a flush after a checkpoint restore overwrites the partial
file it replaces instead of duplicating rows.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.engine import SimState, StepRecord
from repro_torch.core.msp import NeuronState
from repro_torch.core.synapses import SynapseState
from repro_torch.sharding import rules


class ProbeState(NamedTuple):
    """The recording carry: one buffer per probe and a cursor.

    cursor:  () or (K,) int32 numpy: rows already recorded in this chunk.
    step0:   () or (K,) int32 numpy: global step of the chunk's first row
             (rows record post-step state: a chunk started at engine step s
             has step0 = s + 1).
    buffers: probe name -> (chunk_size, *row_shape) tensor, (K, chunk_size,
             *row_shape) for an ensemble.
    """
    cursor: np.ndarray
    step0: np.ndarray
    buffers: Dict[str, torch.Tensor]


class Probe:
    """A named, pure observer of one simulation step.

    Subclasses define `row_struct(n)` -> (row shape, dtype) and
    `observe(prev, new, rec)` -> the row, over state of any leading shape.

    row_sharded: the row's leading dim is the neuron axis, so under the
    distributed engines each rank records only its own rows into a
    (chunk, n/d) buffer, with no collective.
    needs_merge: `observe` returns a per-rank partial (its inputs, the edge
    table, are cut by slot range) that the engine sums over the data group
    (`record`'s merge) before the row is written."""
    name: str = "probe"
    row_sharded: bool = False
    needs_merge: bool = False

    def row_struct(self, n: int) -> Tuple[tuple, torch.dtype]:
        raise NotImplementedError

    def observe(self, prev: SimState, new: SimState, rec: StepRecord) -> torch.Tensor:
        raise NotImplementedError


class SpikeRasterProbe(Probe):
    """(n,) bool per step: which neurons spiked."""
    name = "spikes"
    row_sharded = True

    def row_struct(self, n):
        return (n,), torch.bool

    def observe(self, prev, new, rec):
        return new.neurons.spiked


class CalciumProbe(Probe):
    """(n,) float32 per step: per-neuron intracellular calcium."""
    name = "calcium"
    row_sharded = True

    def row_struct(self, n):
        return (n,), torch.float32

    def observe(self, prev, new, rec):
        return new.neurons.calcium


class TurnoverProbe(Probe):
    """(2, R) int32 per step: synapse births (row 0) and deaths (row 1) per
    region, keyed by the dendrite-side (dst) neuron's region.

    A slot that turns valid is a birth, one that turns invalid a death, and
    a valid slot whose (src, dst) changed is both.  Host-level surgery
    between steps (`apply_lesion`) is invisible to it, as in the reference.
    A step without a connectivity update returns the very edge tensors it
    was given (nothing on the step path writes in place), so such a step's
    row is zero without a pass over the table."""
    name = "turnover"
    row_sharded = False
    needs_merge = True

    def __init__(self, region_of: np.ndarray, num_regions: int, name: str = "turnover"):
        self.region_of = np.asarray(region_of, np.int64)
        self.num_regions = int(num_regions)
        self.name = name
        self._on_device: Dict[torch.device, torch.Tensor] = {}

    def row_struct(self, n):
        return (2, self.num_regions), torch.int32

    def _regions(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._on_device:
            self._on_device[dev] = torch.as_tensor(self.region_of, device=dev)
        return self._on_device[dev]

    def observe(self, prev, new, rec):
        pe, ne = prev.edges, new.edges
        lead = ne.valid.shape[:-1]
        r = self.num_regions
        if pe.src is ne.src and pe.dst is ne.dst and pe.valid is ne.valid:
            return torch.zeros(lead + (2, r), dtype=torch.int32, device=ne.valid.device)
        same = (pe.src == ne.src) & (pe.dst == ne.dst)
        born = ne.valid & (~pe.valid | ~same)
        died = pe.valid & (~ne.valid | ~same)
        regions = self._regions(ne.valid.device)
        rows = int(np.prod(lead, dtype=np.int64))
        offset = (torch.arange(rows, device=ne.valid.device) * r).reshape(lead + (1,))

        def seg(hit, dst):
            ids = (regions[dst.long()] + offset)[hit]
            return torch.bincount(ids, minlength=rows * r).reshape(lead + (r,))
        return torch.stack([seg(born, ne.dst), seg(died, pe.dst)], dim=-2).to(torch.int32)


class ProbeSet:
    """An immutable collection of probes and the shared chunk size.  Probe
    names must be unique: they key the buffers and the on-disk arrays."""

    def __init__(self, probes: Sequence[Probe], chunk_size: int = 1000):
        self.probes = tuple(probes)
        self.chunk_size = int(chunk_size)
        if self.chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        names = [p.name for p in self.probes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate probe names: {names}")

    def init(self, n: int, start_step: int = 0, batch: Optional[int] = None,
             device: str | torch.device = "cuda") -> ProbeState:
        """Zeroed buffers on `device`; the first recorded row is step
        `start_step + 1`.  batch: the replica count K of an ensemble (every
        leaf gains a leading (K,) axis)."""
        dev = _device.resolve(device)
        lead = () if batch is None else (int(batch),)
        buffers = {}
        for p in self.probes:
            shape, dtype = p.row_struct(n)
            buffers[p.name] = torch.zeros(lead + (self.chunk_size,) + tuple(shape),
                                          dtype=dtype, device=dev)
        return ProbeState(cursor=np.zeros(lead, np.int32),
                          step0=np.full(lead, int(start_step) + 1, np.int32),
                          buffers=buffers)

    def record(self, ps: ProbeState, prev: SimState, new: SimState,
               rec: StepRecord, keep: Optional[np.ndarray] = None,
               merge: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> ProbeState:
        """Write one row per probe at the cursor (in place; see the module
        docstring) and return the state with the cursor advanced.  Past the
        chunk's end the last row is overwritten, as the reference's clamped
        write does: flush and `advance` before the cursor reaches it.

        keep: optional (K,) bool of a batched state: only those replicas
        record and advance their cursors; the others are frozen (served
        slots that are empty, finished mid-round, or not recording).
        merge: the distributed engine's data-group sum for `needs_merge`
        probes (None: the partial is the whole row)."""
        rows = np.minimum(ps.cursor, self.chunk_size - 1)
        if keep is not None and keep.all():
            keep = None
        for p in self.probes:
            row = p.observe(prev, new, rec)
            if p.needs_merge and merge is not None:
                row = merge(row)
            buf = ps.buffers[p.name]
            if rows.ndim == 0:
                buf[int(rows)] = row
            elif keep is None and (rows == rows.flat[0]).all():
                buf[:, int(rows.flat[0])] = row
            else:
                for k, c in enumerate(rows):
                    if keep is None or keep[k]:
                        buf[k, int(c)] = row[k]
        step = 1 if keep is None else keep.astype(ps.cursor.dtype)
        return ProbeState(cursor=ps.cursor + step, step0=ps.step0, buffers=ps.buffers)

    def advance(self, ps: ProbeState) -> ProbeState:
        """Start the next chunk: cursor to 0, step0 past the recorded rows.
        Buffers are not zeroed: flushes trim to the cursor."""
        return ProbeState(cursor=np.zeros_like(ps.cursor), step0=ps.step0 + ps.cursor,
                          buffers=ps.buffers)


class ProbeWriter:
    """Flushes chunks to disk, one `chunk_<step0:09d>.npz` per chunk
    (`chunk_<step0:09d>_r<k>.npz` per replica of a batched state), each
    holding `__step0`, `__rows` and one (rows, *row_shape) array per probe.
    Files are published atomically (write, fsync, rename).

    A distributed run's state holds each rank's own rows of a `row_sharded`
    probe: `flush(group=)` gathers them over the data group, once per probe
    and flush, and the group's rank 0 writes the files, which then hold the
    arrays of a single-device run."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _publish(self, fname: str, rows: int, step0: int,
                 buffers: Dict[str, torch.Tensor]) -> str:
        arrays = {"__step0": np.int64(step0), "__rows": np.int64(rows)}
        for name, buf in buffers.items():
            arrays[name] = buf[:rows].cpu().numpy()       # audit: ok (the chunk file)
        final = os.path.join(self.directory, fname)
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        return final

    def flush(self, probe_set: ProbeSet, ps: ProbeState, group=None, replica_offset: int = 0):
        """Write the current chunk; returns the published path (one run), a
        list of per-replica paths (batched), or None if the chunk is empty
        (and on every rank but rank 0 of `group`).

        group: the data group of a distributed run (collective: every rank
        of it must call).  replica_offset: the global index of the state's
        first replica (an ensemble coordinate's block), which names the
        per-replica files."""
        if ps.cursor.ndim > 1:
            raise NotImplementedError(
                "ProbeWriter flushes at most one leading replica axis; "
                f"got cursor of rank {ps.cursor.ndim}")
        if group is not None:
            dim = ps.cursor.ndim + 1              # the neuron dim of a row buffer
            bufs = {p.name: (rules.gather_dim(group, ps.buffers[p.name], dim)
                             if p.row_sharded else ps.buffers[p.name])
                    for p in probe_set.probes}
            if group.rank != 0:
                return None
            ps = ps._replace(buffers=bufs)
        if ps.cursor.ndim == 1:
            paths = []
            for k in range(ps.cursor.shape[0]):
                rows = min(int(ps.cursor[k]), probe_set.chunk_size)
                if rows == 0:
                    continue
                step0 = int(ps.step0[k])
                paths.append(self._publish(f"chunk_{step0:09d}_r{replica_offset + k}.npz", rows,
                                           step0, {n: b[k] for n, b in ps.buffers.items()}))
            return paths or None
        rows = min(int(ps.cursor), probe_set.chunk_size)
        if rows == 0:
            return None
        step0 = int(ps.step0)
        return self._publish(f"chunk_{step0:09d}.npz", rows, step0, ps.buffers)


def read_trajectory(directory: str, name: str,
                    replica: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """One probe's rows across all chunk files: ((T,) int64 global steps,
    (T, *row_shape) values), ordered by step.  replica selects one stream
    of a batched flush; None reads the unbatched `chunk_*.npz` files."""
    suffix = ".npz" if replica is None else f"_r{replica}.npz"
    is_replica_file = lambda f: f.rsplit(".", 1)[0].rpartition("_")[2].startswith("r")
    files = sorted(f for f in os.listdir(directory)
                   if f.startswith("chunk_") and f.endswith(suffix)
                   and (replica is not None or not is_replica_file(f)))
    if not files:
        raise FileNotFoundError(
            f"no chunk files in {directory}"
            + (f" for replica {replica}" if replica is not None else ""))
    steps, values = [], []
    for fname in files:
        with np.load(os.path.join(directory, fname)) as data:
            step0, rows = int(data["__step0"]), int(data["__rows"])
            steps.append(np.arange(step0, step0 + rows, dtype=np.int64))
            values.append(np.asarray(data[name]))
    return np.concatenate(steps), np.concatenate(values)


def simulate_chunked(engine, state: SimState, num_steps: int, probes: ProbeSet, *,
                     seed: int = 0, noise=None, params=None,
                     probe_state: Optional[ProbeState] = None,
                     out_dir: Optional[str] = None,
                     interventions: Optional[Dict[int, Callable]] = None,
                     manager=None) -> Tuple[SimState, StepRecord, ProbeState]:
    """Drive a probed `engine.simulate` in chunk-size segments, flushing each
    full chunk to disk.

    Draws depend on (seed, step) and not on how the run is cut, so the
    chunked run is bit for bit one uninterrupted run.

    probe_state:   resume from an earlier or restored ProbeState (None = a
                   fresh one at the state's step).
    out_dir:       where chunk files go (None = keep the buffers only).
    interventions: {global step: fn(state) -> state}, host-level surgery
                   (e.g. `apply_lesion`) applied when the run reaches that
                   step; a segment is cut there.
    manager:       a `checkpoint.manager.CheckpointManager`; the pair
                   (state, probe_state) is saved after every completed chunk.

    Returns (final state, records of every step, final probe state)."""
    writer = ProbeWriter(out_dir) if out_dir is not None else None
    if probe_state is None:
        probe_state = probes.init(engine.n, start_step=state.step, device=engine.device)
    pending = dict(interventions or {})
    recs = []
    done = 0
    while done < num_steps:
        step_now = state.step
        hook = pending.pop(step_now, None)
        if hook is not None:
            state = hook(state)
        take = min(probes.chunk_size - int(probe_state.cursor), num_steps - done)
        upcoming = [s for s in pending if step_now < s < step_now + take]
        if upcoming:
            take = min(upcoming) - step_now
        state, rec, probe_state = engine.simulate(state, take, seed=seed, noise=noise,
                                                  params=params, probes=probes,
                                                  probe_state=probe_state)
        recs.append(rec)
        done += take
        if int(probe_state.cursor) >= probes.chunk_size:
            if writer is not None:
                writer.flush(probes, probe_state)
            probe_state = probes.advance(probe_state)
            if manager is not None:
                manager.save((state, probe_state), state.step)
    hook = pending.pop(state.step, None)
    if hook is not None:
        state = hook(state)
    if writer is not None:
        writer.flush(probes, probe_state)          # the partial tail chunk
    return state, StepRecord(*(torch.cat(f) for f in zip(*recs))), probe_state


def apply_lesion(state: SimState, mask) -> SimState:
    """Ablate the masked neurons: zero their dynamic state and invalidate
    every synapse that touches them (the paper's lesion scenario).

    mask: (n,) bool, True = lesioned.  Survivors keep their elements, so the
    next updates see vacancies where the dead synapses were and rewire.
    Host-level surgery between steps (`simulate_chunked`'s
    `interventions`); returns new tensors."""
    dev = state.neurons.x.device
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    neurons = NeuronState(*(torch.where(mask, torch.zeros_like(t), t)
                            for t in state.neurons))
    hit = mask[state.edges.src.long()] | mask[state.edges.dst.long()]
    edges = SynapseState(src=state.edges.src, dst=state.edges.dst,
                         valid=state.edges.valid & ~hit)
    return state._replace(neurons=neurons, edges=edges)
