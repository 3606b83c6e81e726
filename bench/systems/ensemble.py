"""The system under test of the `ensemble` kind: `EnsembleEngine.simulate`
over K replicas, driven in episodes of update intervals.

A configuration names its system (`"system": "ensemble"`); the harness
(`bench/run.py`) finds this module as `bench/systems/<system>.py` and
calls, for one run of a cell:

    measure(cell, seed, seconds, trace, device, started) -> window
        set-up, the warm-up, the timed window (with `trace`, the profiled
        intervals); the program's state is freed before it returns;
    end_to_end(window) -> {metric: value}
    context(window) -> the dict each per-layer reader's `read` gets;
    judge(window, seed, device) -> {"worst", "limits", "failed", "checked",
        "attempted"}: each compared number's worst reading beside its limit.

The timing method is `chip_smoke.py`'s `timed_run` (a host clock and a
synchronize around each chunk), with rates taken over the whole window.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from bench.harness import check as ck
from bench.harness import profile as pr
from bench.harness import spec, system, traffic as tr

# The window's intervals that a traced run profiles, each alone: the 2nd and
# the 4th of its first episode, an early and a late one.
PROFILED = (1, 3)
# A window holds at least two intervals, whose checked replicas lie in the
# two halves of the batch (`traffic.checked_replicas`).
MIN_INTERVALS = 2


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window(NamedTuple):
    """What set-up and the window leave for the metrics and the comparison."""
    config: dict
    traffic: dict
    draw: object                  # the mix's start generator
    positions: np.ndarray
    num_replicas: int
    kept: List[ck.Interval]       # one replica's states and records per interval
    act: List[tuple]              # (steps, seconds) of each activity chunk
    upd: List[tuple]              # (steps, seconds) of each update chunk
    setup_s: float
    peak_bytes: int
    profile: Optional[dict]       # the traced chunks (`profile.record`)


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
            started: float | None = None) -> Window:
    """Set-up and the window of one run of `cell`; the program's state is
    freed before it returns.  `started`: the wall-clock time set-up began
    (the process's start, for `setup_s`)."""
    started = time.time() if started is None else started
    config, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    n, interval = config["n"], config["update_interval"]
    chunks = traffic["chunks"]
    if sum(chunks) != interval:
        raise ValueError(f"chunks {chunks} do not add up to the update interval {interval}")
    kinds = ["bench.activity"] * (len(chunks) - 1) + ["bench.update"]
    episode_steps = traffic["episode_steps"]
    if episode_steps % interval:
        raise ValueError(f"episode_steps {episode_steps} is no multiple of {interval}")

    # -- set-up ------------------------------------------------------------------
    log(f"imports done {time.time() - started:.2f} s after the process started")
    positions = tr.positions(seed, n, config["domain"])
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
        log(f"card initialised {time.time() - started:.2f} s after the process started")
    sut = system.build(config, traffic, positions, dev)
    k_reps = sut.num_replicas
    log(f"engine built {time.time() - started:.2f} s after the process started")

    where = torch.as_tensor(positions, device=dev)

    def episode_start(e: int):
        start = tr.start(cell.start.draw, traffic, seed, e, where, config["domain"])
        return system.start_states(sut, start), system.noises(sut, seed, e)

    states, noises = episode_start(0)          # one warm-up interval
    for steps in chunks:
        t = time.perf_counter()
        states, _ = system.run(sut, states, steps, noises)
        _sync(dev)
        log(f"warm-up chunk of {steps} steps: {time.perf_counter() - t:.3f} s")
    del states
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"warmed up {time.time() - started:.2f} s after the process started")

    # -- the window ----------------------------------------------------------------
    episode, step = 1, 0
    states, noises = episode_start(episode)
    order = tr.checked_replicas(seed, k_reps)
    kept, act, upd = [], [], []
    prof, recs_traced = None, []
    profiled = PROFILED if trace else ()
    setup_s = time.time() - started
    timed = 0.0
    # Whole update intervals, until the timed chunks reach `seconds`, the
    # window holds MIN_INTERVALS and the profiled intervals have run.
    while timed < seconds or len(kept) < max(MIN_INTERVALS, max(profiled, default=-1) + 1):
        if step == episode_steps:
            del states
            episode, step = episode + 1, 0
            states, noises = episode_start(episode)
        i = len(kept)
        k = order[i % k_reps]
        pre = None if step == 0 else system.capture(states, k)
        if i in profiled:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        parts = []
        for kind, steps in zip(kinds, chunks):
            with record_function(kind):
                t = time.perf_counter()
                states, recs = system.run(sut, states, steps, noises)
                _sync(dev)
                dt = time.perf_counter() - t
            timed += dt
            (upd if kind == "bench.update" else act).append((steps, dt))
            parts.append(system.replica_records(recs, k))
        if prof is not None:
            prof.__exit__(None, None, None)
            recs_traced.append(pr.record(prof, [[kd, s] for kd, s in zip(kinds, chunks)],
                                         replica_updates=k_reps, rows=k_reps * n))
            prof = None
        kept.append(ck.Interval(episode=episode, step0=step, replica=k, pre=pre,
                                post=system.capture(states, k), records=np.concatenate(parts)))
        step += interval
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"chunks (steps, s): activity {[(a, round(b, 4)) for a, b in act]}, "
        f"update {[(a, round(b, 4)) for a, b in upd]}")
    log(f"window: {len(kept)} intervals, {timed:.3f} s timed, episodes 1..{episode}, "
        f"synapses at the intervals' ends (the kept replica) "
        f"{[int(it.records[-1, 2]) for it in kept]}")
    del states, noises, sut
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return Window(config=config, traffic=traffic, draw=cell.start.draw, positions=positions,
                  num_replicas=k_reps,
                  kept=kept, act=act, upd=upd, setup_s=setup_s, peak_bytes=int(peak),
                  profile=pr.merge(recs_traced) if recs_traced else None)


def end_to_end(w: Window) -> dict:
    """The end-to-end metrics of the window's timed chunks."""
    act_steps, act_s = sum(s for s, _ in w.act), sum(t for _, t in w.act)
    upd_steps, upd_s = sum(s for s, _ in w.upd), sum(t for _, t in w.upd)
    step_s = act_s / act_steps
    return {
        "neuron_steps_per_s": w.num_replicas * w.config["n"] * (act_steps + upd_steps)
        / (act_s + upd_s),
        "activity_step_ms": step_s * 1e3,
        "update_ms": (upd_s - upd_steps * step_s) / len(w.upd) * 1e3,
        "setup_s": w.setup_s,
    }


def compare(w: Window, seed: int, device, control: bool = False) -> List[dict]:
    """The numbers of each checked interval (`check.compare`), the reference
    run on `device` after the program's state is gone."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = ck.Reference(w.config, w.traffic, w.draw, w.positions, device)
    chosen = tr.checked_intervals(seed, len(w.kept), ck.CHECKED_INTERVALS)
    return [ck.compare(ref, seed, w.kept[j], control) for j in chosen]


def context(w: Window) -> dict:
    """What the per-layer readers read: the traced intervals' profile and the
    window's peak of device memory."""
    return {"profile": w.profile, "peak_bytes": w.peak_bytes}


def judge(w: Window, seed: int, device) -> dict:
    """The comparison with the plain reference, once the program's state is
    gone."""
    limits = w.config["limits"]
    t = time.time()
    verdict = ck.judge(compare(w, seed, torch.device(device)), limits)
    log(f"compared {verdict['checked']} intervals with the reference in {time.time() - t:.2f} s")
    return dict(verdict, limits=limits, attempted=len(w.kept) * w.num_replicas)
