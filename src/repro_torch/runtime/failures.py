"""Fault tolerance: restart supervision, straggler mitigation, elastic re-mesh
(port of `repro.runtime.failures`).

This process-level runtime implements the policies a fleet of many hosts
needs; the cluster-manager integration points (preemption signals,
replacement-node provisioning) are explicit hooks.  Everything here is
exercised by tests through fault *injection*: the simulated failure path
runs the identical code.

Components
----------
RestartSupervisor   checkpoint-restore-retry loop around a train function;
                    on failure it restores the latest checkpoint, optionally
                    re-meshes to the surviving device count (elastic), and
                    replays the data stream (deterministic pipeline makes
                    this exact).
StragglerMonitor    per-step wall-time EWMA + robust z-score; flags outlier
                    steps, recommends actions (the paper's rank-to-rank
                    variance discussion is the brain-sim analogue).
plan_elastic_mesh   largest feasible (data, model) mesh from survivors,
                    keeping the model axis (TP requires full groups) and
                    shrinking the data axis, so re-sharding is a pure
                    re-slice of batch + FSDP dims.
reshard             a host-restored tree placed on a (new) layout: each
                    rank keeps only its own blocks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


class TrainingFailure(RuntimeError):
    """Raised by the step loop when a device/host failure is detected
    (surfaced as RuntimeError on real fleets; injected in tests)."""


@dataclasses.dataclass
class RestartReport:
    restarts: int
    completed_steps: int
    resumed_from: List[int]
    final_mesh_devices: int


class RestartSupervisor:
    """Run `train_segment(start_step, num_devices) -> completed_step` under a
    restart policy.

    train_segment must raise TrainingFailure (or any Exception) on failure and
    is responsible for checkpointing via the shared manager; the supervisor
    decides the resume step from the checkpoint directory.
    """

    def __init__(self, ckpt_latest_step: Callable[[], Optional[int]],
                 max_restarts: int = 3,
                 on_restart: Optional[Callable[[int], None]] = None):
        self.ckpt_latest_step = ckpt_latest_step
        self.max_restarts = max_restarts
        self.on_restart = on_restart

    def run(self, train_segment: Callable[[int, int], int],
            total_steps: int, num_devices: int) -> RestartReport:
        restarts = 0
        resumed_from: List[int] = []
        step = (self.ckpt_latest_step() or 0)
        while step < total_steps:
            try:
                step = train_segment(step, num_devices)
            except Exception:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                latest = self.ckpt_latest_step() or 0
                resumed_from.append(latest)
                if self.on_restart is not None:
                    self.on_restart(restarts)
                # Elastic: the caller may shrink num_devices between
                # segments via on_restart mutating shared state; we re-read
                # the checkpoint and continue.
                step = latest
        return RestartReport(restarts=restarts, completed_steps=step,
                             resumed_from=resumed_from,
                             final_mesh_devices=num_devices)


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float
    ratio: float


class StragglerMonitor:
    """Robust per-step outlier detection (median + MAD over a window).

    On a real fleet, per-host step times arrive via the metrics bus; here the
    same logic runs on scalar durations.  `threshold` is the ratio over the
    window median at which a step is flagged — repeated flags on one host are
    the hot-spare swap trigger (hook `on_straggler`).
    """

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        self.window = window
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.durations: List[float] = []
        self.events: List[StragglerEvent] = []

    def record(self, step: int, duration: float) -> Optional[StragglerEvent]:
        self.durations.append(duration)
        hist = self.durations[-self.window:]
        med = float(np.median(hist))
        if len(hist) >= 8 and med > 0 and duration > self.threshold * med:
            ev = StragglerEvent(step=step, duration=duration, median=med,
                                ratio=duration / med)
            self.events.append(ev)
            if self.on_straggler is not None:
                self.on_straggler(ev)
            return ev
        return None

    def timed(self, step: int):
        monitor = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                monitor.record(step, time.perf_counter() - self.t0)
                return False
        return _Ctx()


def plan_elastic_mesh(alive_devices: int, model_parallel: int,
                      pod_size: Optional[int] = None) -> Tuple[int, ...]:
    """Largest (data, model) [or (pod, data, model)] mesh from survivors.

    The model axis is preserved (TP groups must stay whole); the data axis
    shrinks to the largest multiple that fits.  Returns the mesh shape; a
    re-shard is then a placement of the checkpointed state with the new
    sharding (batch/FSDP dims re-slice; nothing model-parallel moves).
    """
    if alive_devices < model_parallel:
        raise ValueError("not enough devices for one model-parallel group")
    data = alive_devices // model_parallel
    if pod_size and alive_devices > pod_size:
        pods = alive_devices // pod_size
        data_per_pod = pod_size // model_parallel
        return (pods, data_per_pod, model_parallel)
    return (data, model_parallel)


def reshard(tree, mesh, spec_fn):
    """Place a host-restored tree on a (new) layout: this rank keeps its
    blocks only (`sharding.rules.shard_leaf` by `mesh.coords`), each a
    tensor of its own on `mesh.device`.

    tree: NamedTuples and dicts of numpy arrays (bfloat16 as ml_dtypes')
    or tensors, keyed by the port's names (a `TrainState` as a checkpoint
    restores it); spec_fn(path, leaf) -> spec, with path the keys down to
    the leaf.  Used after an elastic re-mesh (`plan_elastic_mesh`): the
    checkpoint is on the host, so placement is a cut of each leaf."""
    from repro_torch import convert
    from repro_torch.sharding import rules
    specs = rules.tree_specs(mesh, tree, lambda _, path, leaf: spec_fn(path, leaf))

    def own(block):
        if isinstance(block, np.ndarray):
            return convert._to_torch(block).to(mesh.device)     # a C-order copy
        if isinstance(block, torch.Tensor):
            return block.detach().to(mesh.device, copy=True,
                                     memory_format=torch.contiguous_format)
        return block
    return rules.tree_map(own, rules.shard_tree(specs, tree, coords=mesh.coords))
