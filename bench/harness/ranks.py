"""One rank's side of the `distributed` system: its part of one network on
its own card, the warm-up, the timed window and its captures.

`RankJob` is what `bench/systems/distributed.py` hands the port's launcher
(`repro_torch.launch.distributed.run_ranks`): each spawned rank builds the
port's `DistributedPlasticityEngine` over the Morton-sorted positions,
draws its own block of each episode's start (`starts/network_blocks.py`),
and runs whole update intervals through `DistributedPlasticityEngine.simulate`,
every chunk ending in a synchronize.  Rank 0 decides when the window
closes (its host clock is the clock) and tells the others with a merge
between intervals; every rank profiles the same intervals, and rank 0's
trace and counters are kept.  Each rank copies its part of the checked
intervals' states to its host and sends them to the harness's process
through a pipe, once the window has closed and the engine is freed: no
card ever holds more than its own part.  With them go the names of the
forbidden modules (`bench/run.py`'s FORBIDDEN) the rank has loaded and a
digest of the engine's Morton-sorted positions, which the harness holds
against the reference's own order.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import record_function

from bench.harness import profile as pr
from bench.harness import spec, traffic as tr

START = 7              # a SeedSequence word of the start draws (`traffic._START` is 1)
MIN_INTERVALS = 2
PROFILED = (1, 3)      # as `systems/ensemble.py`: the window's 2nd and 4th intervals
FIELDS = ("x", "refrac", "spiked", "calcium", "ax_elems", "den_elems")
CHUNK_BYTES = 1 << 28  # of an array written to a pipe in one call
PIPE_BYTES = 1 << 20   # the pipe buffer asked for
RANGES = pr.PROGRAM_RANGES + ("dist.",)


def digest(positions: np.ndarray) -> str:
    """SHA-256 of an (n, 3) float32 position table's bytes: equal digests,
    equal neuron order."""
    return hashlib.sha256(memoryview(np.ascontiguousarray(positions, np.float32)).cast("B")
                          ).hexdigest()


def start_gens(seed: int, episode: int, block: int, device):
    """The generators of block `block`'s start draws: j -> a generator on
    `device` seeded from (seed, episode, block, j)."""
    return lambda j: torch.Generator(device=device).manual_seed(
        tr.seed64(seed, START, episode, block, j))


def record(prof, chunk_steps, replica_updates: int, rows: int) -> dict:
    """`profile.record` keeping the collectives' `dist.*` ranges too."""
    chunks, ranges, ops, launches = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_card = e.device_type() == DeviceType.CUDA
        if name.startswith((pr.CHUNK_PREFIX,) + RANGES):
            if not on_card:
                span = [name, e.start_ns(), e.start_ns() + e.duration_ns()]
                (chunks if name.startswith(pr.CHUNK_PREFIX) else ranges).append(span)
        elif on_card:
            ops.append([name, e.start_ns(), e.duration_ns(), e.correlation_id()])
        elif name.startswith(pr.LAUNCH_PREFIXES):
            launches[e.correlation_id()] = e.start_ns()
    ops = [[n, s, d, launches.get(c, s)] for n, s, d, c in ops]
    return dict(chunks=sorted(chunks, key=lambda c: c[1]), ranges=ranges,
                ops=sorted(ops, key=lambda o: o[1]), chunk_steps=chunk_steps,
                activity_steps=sum(s for k, s in chunk_steps if k == "bench.activity"),
                replica_updates=replica_updates, rows=rows)


def pack_bits(valid: torch.Tensor) -> np.ndarray:
    """(E,) bool -> (E/8,) uint8, bit i of byte j the slot 8j + i."""
    w = (1 << torch.arange(8, device=valid.device, dtype=torch.int32))
    return (valid.reshape(-1, 8).to(torch.int32) * w).sum(dim=1).to(torch.uint8).cpu().numpy()


def capture(eng, state) -> dict:
    """This rank's part of a state on the host: its rows' fields, its slot
    range's occupancy bits and the occupied slots' ids, in slot order."""
    v = state.edges.valid
    return dict(neurons={f: getattr(state.neurons, f).cpu().numpy() for f in FIELDS},
                bits=pack_bits(v), src=state.edges.src[v].cpu().numpy(),
                dst=state.edges.dst[v].cpu().numpy(), dropped=int(state.dropped))


def _widen(conn) -> None:
    """Ask for a pipe buffer of PIPE_BYTES (fewer system calls a gigabyte;
    the system may grant less)."""
    try:
        import fcntl
        fcntl.fcntl(conn.fileno(), 1031, PIPE_BYTES)      # F_SETPIPE_SZ
    except (ImportError, OSError):
        pass


def send(conn, parts: Dict[str, dict], meta: dict) -> None:
    """The captures through a pipe: a header of shapes and `meta`, then
    each array's bytes, written from the array's own memory."""
    arrays, header = [], []
    for tag, part in parts.items():
        for key in ("bits", "src", "dst"):
            arrays.append(part[key])
            header.append((tag, key, part[key].dtype.str, part[key].shape))
        for f in FIELDS:
            arrays.append(part["neurons"][f])
            header.append((tag, f, part["neurons"][f].dtype.str, part["neurons"][f].shape))
    conn.send((header, {tag: part["dropped"] for tag, part in parts.items()}, meta))
    _widen(conn)
    fd = conn.fileno()
    for a in arrays:
        mv = memoryview(np.ascontiguousarray(a)).cast("B")
        at = 0
        while at < len(mv):
            at += os.write(fd, mv[at:at + CHUNK_BYTES])
    conn.close()


def receive(conn, on_header=None) -> Tuple[Dict[str, dict], dict]:
    """`send`'s captures, read straight into their arrays, and its `meta`;
    `on_header()`, if given, is called once the header has come (the
    sending rank's window is over)."""
    header, dropped, meta = conn.recv()
    if on_header is not None:
        on_header()
    _widen(conn)
    fd = conn.fileno()
    out = {tag: {"neurons": {}, "dropped": d} for tag, d in dropped.items()}
    for tag, key, dtype, shape in header:
        a = np.empty(shape, dtype=np.dtype(dtype))
        mv = memoryview(a).cast("B")
        at = 0
        while at < len(mv):
            got = os.readv(fd, [mv[at:at + CHUNK_BYTES]])
            if not got:
                raise EOFError(f"the pipe closed with {len(mv) - at} bytes of {tag}.{key} unread")
            at += got
        (out[tag]["neurons"] if key in FIELDS else out[tag])[key] = a
    conn.close()
    return out, meta


@dataclasses.dataclass
class RankJob:
    """One run of the cell on the ranks of a launcher's layout (a job with
    `run(groups, device)`, run with `ensemble=1`: the data group is every
    rank)."""
    root: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    checked: tuple            # the window's intervals whose states are kept
    senders: list             # one pipe end per rank

    def run(self, groups, device) -> Optional[dict]:
        return run_rank(self, groups.data, device)


def _engine(job: RankJob, group, device, positions):
    from repro_torch.core.distributed import DistributedPlasticityEngine
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.msp import MSPConfig
    from repro_torch.core.traversal import FMMConfig
    c = job.config
    msp = MSPConfig(**{f.name: c[f.name] for f in dataclasses.fields(MSPConfig)})
    fmm = FMMConfig(sigma=c["sigma"], p=c["p"], c1=c["c1"], c2=c["c2"],
                    size_guard=c["fmm"]["size_guard"])
    e = c["engine"]
    eng_cfg = EngineConfig(method=e["method"], domain=c["domain"],
                           edge_capacity_per_neuron=e["edge_capacity_per_neuron"],
                           max_requests_per_neuron=e["max_requests_per_neuron"],
                           pyramid=e["pyramid"], rng=e["rng"],
                           inhibitory_fraction=e["inhibitory_fraction"])
    options = {k: v for k, v in c["distributed"].items() if k != "ranks"}
    return DistributedPlasticityEngine(positions, group, msp, fmm, eng_cfg, device=device,
                                       **options)


def run_rank(job: RankJob, g, device) -> Optional[dict]:
    from repro_torch import trace as counters
    from repro_torch.core import noise as _noise
    c, traffic = job.config, job.traffic
    begun = time.time()
    rank, world = g.rank, g.size
    if device != "cpu":
        # The host's cores shared among the ranks (the set-up's sorts and
        # gathers run on PyTorch's threads).
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    draw = spec._module("starts", traffic["start"]["generator"], spec.Path(job.root))
    positions = tr.positions(job.seed, c["n"], c["domain"])
    marks = {"positions_drawn": time.time() - begun}
    # The engine keeps its positions in Morton order (`eng.positions`).
    eng = _engine(job, g, device, positions)
    del positions
    dev = eng.device
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    lookup = draw.Lookup(eng.positions, c["domain"])
    lo, hi = eng.row_range
    interval, chunks = c["update_interval"], traffic["chunks"]
    kinds = ["bench.activity"] * (len(chunks) - 1) + ["bench.update"]
    marks["engine_built"] = time.time() - begun

    def episode_start(e: int):
        fields, src, dst = draw.draw_block(traffic["start"], start_gens(job.seed, e, rank, dev),
                                           eng.positions, c["domain"], lookup, rank, world)
        indeg = g.merge(draw.in_degree(dst, eng.n))
        st = eng.init_state()
        st = st._replace(neurons=st.neurons._replace(
            calcium=fields["calcium"], ax_elems=fields["ax_elems"],
            den_elems=draw.den_elems(indeg[lo:hi], fields["den_slack"])))
        k = src.shape[0]
        if k > st.edges.valid.shape[0]:
            raise ValueError(f"rank {rank}: the start's {k} synapses exceed its "
                             f"{st.edges.valid.shape[0]} slots")
        st.edges.src[:k] = src
        st.edges.dst[:k] = dst
        st.edges.valid[:k] = True
        return st, _noise.for_config(c["engine"]["rng"], tr.noise_seed(job.seed, e, 0), dev)

    def run(st, steps, nz):
        st, recs = eng.simulate(st, steps, noise=nz)
        sync()
        return st, recs

    state, nz = episode_start(0)              # the warm-up: one interval
    for steps in chunks:
        state, _ = run(state, steps, nz)
    del state
    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    marks["warmed_up"] = time.time() - begun

    profiled = PROFILED if job.trace else ()
    need = max((MIN_INTERVALS - 1, max(profiled, default=0), max(job.checked)))
    episode, step = 1, 0
    t = time.time()
    state, nz = episode_start(episode)
    marks["episode_draw_s"] = [time.time() - t]
    window_start = time.time()
    act, upd, synapses, kept, parts = [], [], [], [], {}
    spent = {"profiler": 0.0, "record": 0.0, "capture": 0.0}   # untimed seconds in the window
    recs_traced, counts = [], {k: {} for k in set(kinds)}
    timed, i = 0.0, 0
    flag = lambda v: torch.tensor([int(v)], dtype=torch.int64, device=dev)
    while bool(g.merge(flag(rank == 0 and (timed < job.seconds or i <= need)))[0]):
        if step == traffic["episode_steps"]:
            del state
            episode, step = episode + 1, 0
            t = time.time()
            state, nz = episode_start(episode)
            marks["episode_draw_s"].append(time.time() - t)
        if i in job.checked and step != 0 and f"post{i - 1}" not in parts:
            t = time.time()
            parts[f"pre{i}"] = capture(eng, state)
            spent["capture"] += time.time() - t
        prof = None
        if i in profiled:
            t = time.time()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            spent["profiler"] += time.time() - t
        rows = []
        for kind, steps in zip(kinds, chunks):
            if prof is not None:
                counters.reset()
            with record_function(kind):
                t = time.perf_counter()
                state, recs = run(state, steps, nz)
                dt = time.perf_counter() - t
            if prof is not None:
                for name, v in counters.counts().items():
                    counts[kind][name] = counts[kind].get(name, 0) + v
            timed += dt
            (upd if kind == "bench.update" else act).append((steps, dt))
            rows.append(np.stack([f.double().cpu().numpy() for f in recs], axis=1))
        if prof is not None:
            t = time.time()
            prof.__exit__(None, None, None)
            spent["profiler"] += time.time() - t
            t = time.time()
            if rank == 0:
                recs_traced.append(record(prof, [[k, s] for k, s in zip(kinds, chunks)],
                                          replica_updates=1, rows=eng.n))
            del prof
            spent["record"] += time.time() - t
        records = np.concatenate(rows)
        synapses.append(int(records[-1, 2]))
        if i in job.checked:
            t = time.time()
            parts[f"post{i}"] = capture(eng, state)
            spent["capture"] += time.time() - t
            kept.append(dict(index=i, episode=episode, step0=step, records=records))
        step += interval
        i += 1
    window_end = time.time()
    marks["window_untimed_s"] = {k: round(v, 2) for k, v in spent.items()}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    peaks = g.gather_objects(int(peak))
    order = digest(eng.positions_np)
    del state, nz, eng, lookup
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from bench.run import forbidden_modules
    t = time.time()
    marks["freed_s"] = t - window_end
    send(job.senders[rank], parts, dict(loaded=forbidden_modules(), positions=order))
    marks["sent_s"] = time.time() - t
    if rank != 0:
        return None
    return dict(act=act, upd=upd, kept=kept, synapses=synapses, marks=marks,
                window_start=window_start, window_end=window_end, begun=begun, peaks=peaks,
                episodes=episode,
                profile=pr.merge(recs_traced) if recs_traced else None,
                counts=counts if job.trace else None)
