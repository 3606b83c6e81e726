"""The traced run's profile as plain data, and the arithmetic over it.

`record(prof, ...)` turns a `torch.profiler` result into a dict that holds
only numbers and names (so a test can hold the arithmetic to a recorded
fixture):

    chunks   [[kind, start_ns, end_ns]]  the harness's timed chunks
             (`bench.activity`, `bench.update`), each ending in a
             synchronize, so every device operation launched in it ends
             inside it;
    ranges   [[name, start_ns, end_ns]]  the program's record_function
             ranges (`step.*`, `update.*`, `pyramid.*`, `traversal.*`,
             `bh.*`) on the host;
    ops      [[name, start_ns, dur_ns, launch_ns]]  every device operation
             (kernel, copy, memset), with the host time of the runtime call
             that launched it;
    chunk_steps  [[kind, steps]]  the steps each profiled chunk ran;
    activity_steps, replica_updates, rows
             the work of the profiled chunks: steps in all, connectivity
             updates of single replicas, and neuron rows a step.

A device operation belongs to a range when the call that launched it ran
inside the range on the host.  The idle share is `chip_smoke.py`'s
`profile_window` method (1 - busy / profiled wall), over the chunks only.  Device times are the summed durations of
those operations: on one stream they do not overlap.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

from torch.autograd import DeviceType

CHUNK_PREFIX = "bench."
PROGRAM_RANGES = ("step.", "update.", "pyramid.", "traversal.", "bh.", "direct.", "slots.")
LAUNCH_PREFIXES = ("cuda", "cu")      # cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel...


def record(prof, chunk_steps: List[List], replica_updates: int, rows: int) -> dict:
    """The profile of the chunks run under `prof` as plain data.  An event
    on the card is a device operation unless it is a range's device-side
    copy (named like the range); on the host, the ranges are told by their
    names and the launching calls by the CUDA runtime's and driver's names,
    whose correlation ids the device operations carry."""
    chunks, ranges, ops, launches = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_card = e.device_type() == DeviceType.CUDA
        if name.startswith((CHUNK_PREFIX,) + PROGRAM_RANGES):
            if not on_card:
                span = [name, e.start_ns(), e.start_ns() + e.duration_ns()]
                (chunks if name.startswith(CHUNK_PREFIX) else ranges).append(span)
        elif on_card:
            ops.append([name, e.start_ns(), e.duration_ns(), e.correlation_id()])
        elif name.startswith(LAUNCH_PREFIXES):
            launches[e.correlation_id()] = e.start_ns()
    ops = [[n, s, d, launches.get(c, s)] for n, s, d, c in ops]
    return dict(chunks=sorted(chunks, key=lambda c: c[1]), ranges=ranges,
                ops=sorted(ops, key=lambda o: o[1]), chunk_steps=chunk_steps,
                activity_steps=sum(s for _, s in chunk_steps),
                replica_updates=replica_updates, rows=rows)


def merge(recs: List[dict]) -> dict:
    """One record of several profiled stretches (`record` of each)."""
    rows = {r["rows"] for r in recs}
    if len(rows) != 1:
        raise ValueError(f"records of different row counts {sorted(rows)}")
    out = dict(chunks=[], ranges=[], ops=[], chunk_steps=[], activity_steps=0,
               replica_updates=0, rows=rows.pop())
    for r in recs:
        for key in ("chunks", "ranges", "ops", "chunk_steps"):
            out[key] += r[key]
        out["activity_steps"] += r["activity_steps"]
        out["replica_updates"] += r["replica_updates"]
    out["chunks"].sort(key=lambda c: c[1])
    out["ops"].sort(key=lambda o: o[1])
    return out


def _sorted(spans: Iterable[List]):
    spans = sorted(spans, key=lambda s: s[1])
    return spans, [s[1] for s in spans]


def _innermost(t: int, spans, starts, reach: int = 64) -> Optional[List]:
    """The latest-starting of the (nested) spans that holds host time t, or
    None.  Ranges nest a few deep, so a short look back suffices."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if spans[j][1] <= t <= spans[j][2]:
            return spans[j]
    return None


def _launched_in(ops: List[List], spans: List[List]) -> List[List]:
    """The operations whose launch lies in one of the disjoint `spans`."""
    spans, starts = _sorted(spans)
    out = []
    for o in ops:
        i = bisect.bisect_right(starts, o[3]) - 1
        if i >= 0 and o[3] <= spans[i][2]:
            out.append(o)
    return out


def chunk_ops(rec: dict, kind: Optional[str] = None) -> List[List]:
    """Device operations launched inside the chunks (of one kind, e.g.
    'bench.activity')."""
    return _launched_in(rec["ops"], [c for c in rec["chunks"] if kind in (None, c[0])])


def range_device_s(rec: dict, names: Iterable[str]) -> Optional[float]:
    """Summed device seconds of the operations launched inside the ranges
    named in `names` (ranges that do not nest, such as one layer's); None
    if no such range ran."""
    names = set(names)
    spans = [r for r in rec["ranges"] if r[0] in names]
    if not spans:
        return None
    return sum(o[2] for o in _launched_in(rec["ops"], spans)) / 1e9


def window_s(rec: dict) -> float:
    """Host seconds of the profiled chunks."""
    return sum(c[2] - c[1] for c in rec["chunks"]) / 1e9


def _timeline(rec: dict):
    """Per chunk, the busy stretches of the device inside it and the idle
    gaps between them: yields (chunk, busy ns, [(gap ns, op ending it)])."""
    for chunk in rec["chunks"]:
        _, c0, c1 = chunk
        end, busy, gaps = c0, 0, []
        for o in rec["ops"]:
            s, e = max(o[1], c0), min(o[1] + o[2], c1)
            if e <= s:
                continue
            if s > end:
                gaps.append((s - end, o))
            busy += max(0, e - max(s, end))
            end = max(end, e)
        if c1 > end:
            gaps.append((c1 - end, None))
        yield chunk, busy, gaps


def busy_s(rec: dict) -> float:
    """Seconds in which a device operation ran, inside the chunks (the union
    of the operations' intervals, clipped to each chunk)."""
    return sum(busy for _, busy, _ in _timeline(rec)) / 1e9


def top_ops(rec: dict, count: int = 10) -> List[List]:
    """[[name, seconds]] of the device operations that took most time, by
    name, inside the chunks."""
    by: Dict[str, int] = defaultdict(int)
    for name, _, d, _ in chunk_ops(rec):
        by[name[:160]] += d
    return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:count]]


def idle_gaps(rec: dict, count: int = 10) -> List[List]:
    """[[what the host was doing, seconds]]: the device's idle time inside
    the chunks, summed by the innermost program range that held the launch
    ending each gap; outside every range, the chunk's name; a chunk's tail
    after its last operation, "<chunk> (sync)"."""
    ranges, starts = _sorted(rec["ranges"])
    by: Dict[str, int] = defaultdict(int)
    for (kind, _, _), _, gaps in _timeline(rec):
        for gap, op in gaps:
            if op is None:
                by[kind + " (sync)"] += gap
                continue
            inner = _innermost(op[3], ranges, starts) if ranges else None
            by[inner[0] if inner else kind] += gap
    return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:count]]
