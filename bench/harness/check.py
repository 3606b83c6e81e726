"""The comparison that decides `correct`.

For each checked interval of the window (one replica of one update
interval), the plain reference (`bench/reference/`) runs the interval's
steps again, activity steps and the connectivity update, from the state
the replica had when the interval began, with its own draws derived from
the seed, and the harness compares what the program's timed path produced
at the interval's end:

    neuron_rows_differing  share of the replica's neuron rows whose state
                           (activity, refractory count, spike, calcium, both
                           element counts) differs from the reference's in
                           any bit;
    records_differing      share of the interval's step records (calcium
                           mean and spread, spike rate, and the synapse
                           count of the steps before the update) that
                           differ in any bit;
    synapses_differing     the edges of one side missing from the other,
                           counted as multisets of (src, dst) pairs, over
                           the reference's synapse count.

An episode's first interval starts from the mix's drawn start state, which
the benchmark makes and hands to both sides.  A later interval starts from
the program's own state at that point: the reference follows the program
interval by interval, so one rounding difference in a search does not
carry into the intervals after it.

With `control=True` the program's side is replaced by the reference
computed in bfloat16, the precision below the configuration's float32:
the control, which has to come out not correct.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from bench.harness import traffic as tr
from bench.harness.system import Capture
from bench.reference import neurons as nr
from bench.reference.draws import Draws
from bench.reference import octree as ot
from bench.reference import search as sr
from bench.reference import update as ur

NUMBERS = ("neuron_rows_differing", "records_differing", "synapses_differing")
CHECKED_INTERVALS = 8     # of a run's window, drawn from the seed
FIELDS = ("x", "refrac", "spiked", "calcium", "ax_elems", "den_elems")


class Interval(NamedTuple):
    """What the window kept of one interval of one replica."""
    episode: int
    step0: int                  # the step counter when the interval began
    replica: int
    pre: Optional[Capture]      # None: the episode's start state
    post: Capture
    records: np.ndarray         # (steps, 4) the program's step records


class Reference:
    """The reference's static part for one run: the octree of the run's
    positions and each replica's knobs."""

    def __init__(self, config: dict, traffic: dict, draw, positions: np.ndarray, device):
        self.config, self.traffic, self.draw = config, traffic, draw
        self.device = torch.device(device)
        self.n = positions.shape[0]
        self.tree = ot.build_tree(positions, config["domain"], self.device)
        self.positions = torch.as_tensor(positions, device=self.device)
        self.msp = nr.from_config(config)
        self.points = tr.grid(traffic)
        self.capacity = config["engine"]["edge_capacity_per_neuron"] * self.n

    def replica(self, k: int) -> ur.Replica:
        f = self.config
        point = self.points[k]
        sigma = np.float32(point.get("sigma", f["sigma"]))
        search = sr.Search(sigma=sigma, delta=sigma ** 2, guard_delta=float(f["sigma"] ** 2),
                           p=int(f["p"]), c1=np.float32(point.get("c1", f["c1"])),
                           c2=np.float32(point.get("c2", f["c2"])),
                           size_guard=float(f["fmm"]["size_guard"]))
        frac = point.get("inhibitory_fraction", self.config["engine"]["inhibitory_fraction"])
        return ur.Replica(method=self.config["engine"]["method"], tree=self.tree,
                          positions=self.positions, msp=self.msp, search=search,
                          sign=ur.inhibitory_sign(self.n, frac, self.device),
                          max_requests=int(self.config["engine"]["max_requests_per_neuron"]))

    def start(self, seed: int, it: Interval):
        """The state the interval began from, on the device."""
        dev, n = self.device, self.n
        if it.pre is None:
            st = tr.start(self.draw, self.traffic, seed, it.episode, self.positions,
                          self.config["domain"])
            nrn = nr.Neurons(x=torch.full((n,), self.msp.x0, dtype=torch.float32, device=dev),
                             refrac=torch.zeros((n,), dtype=torch.int32, device=dev),
                             spiked=torch.zeros((n,), dtype=torch.bool, device=dev),
                             calcium=st.fields["calcium"], ax_elems=st.fields["ax_elems"],
                             den_elems=st.fields["den_elems"])
            slots = torch.arange(st.src.shape[0], device=dev)
            src, dst = st.src, st.dst
        else:
            nrn = nr.Neurons(*(torch.as_tensor(it.pre.neurons[f], device=dev) for f in FIELDS))
            slots, src, dst = it.pre.slots, it.pre.src, it.pre.dst
        e = self.capacity
        edges = ur.Edges(src=torch.zeros((e,), dtype=torch.int32, device=dev),
                         dst=torch.zeros((e,), dtype=torch.int32, device=dev),
                         valid=torch.zeros((e,), dtype=torch.bool, device=dev))
        at = torch.as_tensor(slots, device=dev)
        edges.src[at] = torch.as_tensor(src, device=dev)
        edges.dst[at] = torch.as_tensor(dst, device=dev)
        edges.valid[at] = True
        return nrn, edges

    def run(self, seed: int, it: Interval, dtype=torch.float32) -> ur.IntervalResult:
        nrn, edges = self.start(seed, it)
        draws = Draws(tr.noise_seed(seed, it.episode, it.replica), self.device)
        return ur.run_interval(self.replica(it.replica), nrn, edges, draws, it.step0,
                               it.records.shape[0], dtype)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32) if a.dtype == np.float32 else a


def rows_differing(got: Dict[str, np.ndarray], want: nr.Neurons) -> float:
    diff = None
    for f in FIELDS:
        w = getattr(want, f).cpu().numpy()
        d = _bits(np.ascontiguousarray(got[f])) != _bits(np.ascontiguousarray(w))
        diff = d if diff is None else diff | d
    return float(diff.mean()) if diff.size else 0.0


def records_array(recs: List[nr.Records]) -> np.ndarray:
    return torch.stack([torch.stack([v.double() for v in r]) for r in recs]).cpu().numpy()


def records_differing(got: np.ndarray, want: np.ndarray, first_update: int) -> float:
    """Over the records that the activity steps decide: every column but the
    synapse count from the update's step on, which the search decides and
    `synapses_differing` judges."""
    judged = np.ones(got.shape, bool)
    judged[first_update:, 2] = False
    return float((got != want)[judged].mean()) if judged.any() else 0.0


def edge_keys(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    return src.astype(np.int64) * n + dst.astype(np.int64)


def multiset_gap(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of either multiset missing from the other."""
    keys, inv = torch.unique(torch.cat([a, b]), return_inverse=True)
    na = torch.bincount(inv[:a.shape[0]], minlength=keys.shape[0])
    nb = torch.bincount(inv[a.shape[0]:], minlength=keys.shape[0])
    return int((na - nb).abs().sum())


def synapses_differing(got_src, got_dst, want: ur.Edges, n: int) -> float:
    live = want.valid
    ref = want.src[live].long() * n + want.dst[live].long()
    got = torch.as_tensor(edge_keys(got_src, got_dst, n), device=ref.device)
    return multiset_gap(got, ref) / max(ref.shape[0], 1)


def compare(ref: Reference, seed: int, it: Interval, control: bool = False) -> Dict[str, float]:
    """The three numbers of one checked interval."""
    want = ref.run(seed, it)
    if control:
        low = ref.run(seed, it, torch.bfloat16)
        live = low.edges.valid
        got_nrn = {f: getattr(low.neurons, f).cpu().numpy() for f in FIELDS}
        got_src = low.edges.src[live].cpu().numpy()
        got_dst = low.edges.dst[live].cpu().numpy()
        got_recs = records_array(low.records)
    else:
        got_nrn, got_src, got_dst, got_recs = it.post.neurons, it.post.src, it.post.dst, \
            it.records
    every = ref.msp.update_interval
    first_update = next((i for i in range(it.records.shape[0])
                         if (it.step0 + i + 1) % every == 0), it.records.shape[0])
    return {"neuron_rows_differing": rows_differing(got_nrn, want.neurons),
            "records_differing": records_differing(got_recs, records_array(want.records),
                                                   first_update),
            "synapses_differing": synapses_differing(got_src, got_dst, want.edges, ref.n)}


def judge(readings: List[Dict[str, float]], limits: Dict[str, float]) -> dict:
    """The worst reading of each number over the checked intervals, beside
    its limit, and how many intervals read over a limit."""
    worst = {k: max((r[k] for r in readings), default=float("nan")) for k in NUMBERS}
    failed = sum(any(r[k] > limits[k] for k in NUMBERS) for r in readings)
    return dict(worst=worst, failed=failed, checked=len(readings))
