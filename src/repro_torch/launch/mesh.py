"""The mesh axes of the distributed engines and of the LM over
`torch.distributed` (port of `repro/launch/mesh.py`).

The JAX engines name a mesh axis in their collectives; the port runs one
process per rank and hands the engines a `Group` per axis, whose methods
are the collectives the reference's helpers take as callables:

    gather(x)       lax.all_gather(x, tiled=True)   dist.all_gather_into_tensor
    merge(x)        lax.psum(x)                     dist.all_reduce(SUM)
    reduce(x)       lax.psum(x) in float32          dist.all_reduce(SUM)
    grad_sum(x)     (a backward's float32 psum)     dist.all_reduce(SUM)
    scatter_sum(x)  lax.psum_scatter(x, dim 0)      dist.reduce_scatter_tensor
    all_to_all(x)   lax.all_to_all(x, 0, 0)         dist.all_to_all_single
    gather_objects  (host objects, results only)    dist.all_gather_object
    gather_to_host  (checkpoints: to one rank)       dist.send / dist.recv

Each collective runs in a `dist.<op>` range (`record_function`) and, while
a profiler records, counts its calls and bytes in `repro_torch.trace`
(`dist.<op>.calls`, `dist.<op>.bytes`: what `CountingGroup` counts).
A bool tensor travels as uint8.  A group carries the name of its axis
(`rules.DATA` or `rules.ENSEMBLE`): the step loops make collectives on data
groups only, and an ensemble group (its rank is the ensemble coordinate) carries
nothing but the gathers of results after a run.  This module is the only
one that calls `torch.distributed`'s collectives.

`make_data_group` starts a 1-D data layout, `make_ensemble_group` a 1-D
replica layout, `make_sweep_groups` the 2-D (ensemble x data) one, and
`make_host_mesh` the LM's (data x model) layout (`LMGroups`: a group per
axis, the fsdp group and the world): NCCL for the card, gloo for the CPU,
and no fallback from one to the other.  `make_production_mesh` is the
reference's 16 x 16 or 2 x 16 x 16 layout seen from one rank, of
`ShapeGroup`s: the spec arithmetic of a layout with more ranks than there
are processes.  `CountingGroup` records the calls and bytes of each
collective (the census, the tests and chip_smoke.py read it).
`ShapeGroup` knows its size only, for the static counters of a layout with
more ranks than there are processes.  `MetaGroup` moves shapes: each
collective answers a meta tensor with a new meta tensor of the result's
shape and dtype, so a step runs whole on meta tensors as one rank of a
layout of any size sees it (`meta_layout`, the dry run of
`launch/dryrun.py`).
"""
from __future__ import annotations

import datetime
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch import device as _device
from repro_torch import trace
from repro_torch.sharding.rules import DATA, ENSEMBLE, MODEL, POD, block_of, coords_of


def _op(name: str, nbytes: int):
    """The range of one collective, `dist.<name>`, and its counts while a
    profiler records (`repro_torch.trace`): `dist.<name>.calls` and
    `dist.<name>.bytes`, the bytes `CountingGroup` counts for it."""
    trace.count(f"dist.{name}.calls", 1)
    trace.count(f"dist.{name}.bytes", nbytes)
    return record_function(f"dist.{name}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Group:
    """One rank's view of a `torch.distributed` process group (None = the
    default group).  Each collective runs in a `dist.<op>` range and, while
    a profiler records, counts its calls and bytes (`_op`)."""

    def __init__(self, pg=None, name: str = DATA):
        self.pg = pg
        self.name = name
        self.rank = dist.get_rank(pg)
        self.size = dist.get_world_size(pg)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend(pg) == "nccl" else torch.device("cpu"))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated along dim 0, in rank order."""
        src = x.contiguous().view(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        with _op("gather", self.size * _nbytes(src)):
            out = src.new_empty((self.size * src.shape[0],) + tuple(src.shape[1:]))
            dist.all_gather_into_tensor(out, src, group=self.pg)
        return out.view(torch.bool) if x.dtype == torch.bool else out

    def merge(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x (exact for integers, and for floats
        where at most one rank holds a value other than zero)."""
        with _op("merge", _nbytes(x)):
            out = x.clone()
            dist.all_reduce(out, group=self.pg)
        return out

    def _sum_f32(self, name: str, x: torch.Tensor) -> torch.Tensor:
        with _op(name, 4 * x.numel()):
            out = x.to(torch.float32, copy=True)
            dist.all_reduce(out, group=self.pg)
        return out

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x in float32 (a float32 tensor; the
        tensor-parallel partial products).  Every rank gets the same bits."""
        return self._sum_f32("reduce", x)

    def grad_sum(self, x: torch.Tensor) -> torch.Tensor:
        """`reduce` in a backward: the float32 sum of every rank's partial
        gradient (the tensor-parallel step's sums over the model axis,
        counted apart from the forward's)."""
        return self._sum_f32("grad_sum", x)

    def scatter_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x: (size, ...) -> (...): block `rank` of the sum over ranks."""
        with _op("scatter_sum", _nbytes(x)):
            out = x.new_empty(tuple(x.shape[1:]))
            dist.reduce_scatter_tensor(out, x.reshape((-1,) + tuple(x.shape[2:])).contiguous(),
                                       group=self.pg)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x: (size, ...) -> (size, ...): entry i of the result is rank i's
        x[rank] (entry j of x goes to rank j)."""
        with _op("all_to_all", _nbytes(x)):
            src = x.contiguous()
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src, group=self.pg)
        return out

    def gather_objects(self, obj) -> list:
        """Every rank's picklable host object, in rank order."""
        with _op("gather_objects", 0):
            out = [None] * self.size
            dist.all_gather_object(out, obj, group=self.pg)
        return out

    def gather_to_host(self, parts: List[torch.Tensor], dst: int = 0) -> Optional[list]:
        """Every rank's list of parts on the host of rank `dst`: there, a
        list in rank order of each rank's parts on the CPU; None on the
        other ranks.  Every rank passes parts of the same shapes and dtypes
        (host or device tensors).  They travel one at a time, by
        point-to-point sends through the group's device, so no device holds
        more than its own parts and one more: a checkpoint of a state that
        no card holds whole."""
        with _op("gather_to_host", sum(_nbytes(p) for p in parts)):
            return self._gather_to_host(parts, dst)

    def _gather_to_host(self, parts: List[torch.Tensor], dst: int) -> Optional[list]:
        peer = (lambda r: r) if self.pg is None else (lambda r: dist.get_global_rank(self.pg, r))
        wire = lambda t: t.view(torch.uint8) if t.dtype == torch.bool else t
        if self.rank != dst:
            for p in parts:
                dist.send(wire(p.to(self.device).contiguous()), peer(dst), group=self.pg)
            return None
        out = []
        for r in range(self.size):
            if r == dst:
                out.append([p.cpu() for p in parts])
                continue
            got = []
            for p in parts:
                buf = torch.empty(p.shape, dtype=p.dtype, device=self.device)
                dist.recv(wire(buf), peer(r), group=self.pg)
                got.append(buf.cpu())
            out.append(got)
        return out


class ShapeGroup:
    """A group of `size` ranks seen from `rank` that performs no collective
    (the static counters of `DistributedPlasticityEngine`)."""

    def __init__(self, size: int, rank: int = 0, name: str = DATA):
        self.size, self.rank, self.name = int(size), int(rank), name
        self.device = torch.device("cpu")

    def _none(self, x):
        raise RuntimeError("ShapeGroup performs no collectives")

    gather = merge = reduce = grad_sum = scatter_sum = all_to_all = gather_objects = _none
    gather_to_host = _none


class MetaGroup:
    """A group of `size` ranks seen from `rank` whose collectives move shapes
    only: each takes a meta tensor and returns a new meta tensor of the
    shape and dtype the real collective's result has (no storage, no
    value).  The host-object collectives raise: a dry run has no objects to
    gather."""

    def __init__(self, size: int, rank: int = 0, name: str = DATA):
        self.size, self.rank, self.name = int(size), int(rank), name
        self.device = torch.device("meta")

    def _meta(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "meta":
            raise ValueError(f"MetaGroup {self.name}: a collective of a tensor on {x.device}; "
                             f"a meta layout moves meta tensors only")
        return x

    def gather(self, x):
        x = self._meta(x)
        return x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))

    def merge(self, x):
        return torch.empty_like(self._meta(x))

    def reduce(self, x):
        return self._meta(x).new_empty(x.shape, dtype=torch.float32)

    def grad_sum(self, x):
        return self.reduce(x)

    def scatter_sum(self, x):
        return self._meta(x).new_empty(tuple(x.shape[1:]))

    def all_to_all(self, x):
        return torch.empty_like(self._meta(x))

    def gather_objects(self, obj):
        raise RuntimeError("MetaGroup gathers no host objects")

    def gather_to_host(self, parts, dst=0):
        raise RuntimeError("MetaGroup gathers nothing to a host")


class CountingGroup:
    """A group that counts, per collective, its calls and the elements and
    bytes of the whole vector it moves: a gather's output, a merge's input,
    a reduce's and a grad_sum's float32 vector, a scatter_sum's and an
    all_to_all's input, a
    gather_to_host's parts (as sent).  "largest" is the most bytes one call
    moved (for gather_to_host, one message)."""

    NAMES = ("gather", "merge", "scatter_sum", "gather_objects", "gather_to_host")
    LM_NAMES = NAMES + ("reduce", "grad_sum", "all_to_all")   # the LM layout's groups too

    def __init__(self, inner, names: Sequence[str] = NAMES):
        self.inner, self.names = inner, tuple(names)
        self.rank, self.size, self.name = inner.rank, inner.size, inner.name
        self.device = inner.device
        self.reset()

    def reset(self) -> None:
        self.counts: Dict[str, Dict[str, int]] = {
            k: {"calls": 0, "elements": 0, "bytes": 0, "largest": 0} for k in self.names}

    def _count(self, name: str, t: torch.Tensor) -> None:
        c = self.counts[name]
        c["calls"] += 1
        c["elements"] += t.numel()
        c["bytes"] += t.numel() * t.element_size()
        c["largest"] = max(c["largest"], t.numel() * t.element_size())

    def gather(self, x):
        out = self.inner.gather(x)
        self._count("gather", out)
        return out

    def merge(self, x):
        self._count("merge", x)
        return self.inner.merge(x)

    def reduce(self, x):
        out = self.inner.reduce(x)
        self._count("reduce", out)
        return out

    def grad_sum(self, x):
        out = self.inner.grad_sum(x)
        self._count("grad_sum", out)
        return out

    def scatter_sum(self, x):
        self._count("scatter_sum", x)
        return self.inner.scatter_sum(x)

    def all_to_all(self, x):
        self._count("all_to_all", x)
        return self.inner.all_to_all(x)

    def gather_objects(self, obj):
        self.counts["gather_objects"]["calls"] += 1
        return self.inner.gather_objects(obj)

    def gather_to_host(self, parts, dst=0):
        c = self.counts["gather_to_host"]
        c["calls"] += 1
        for p in parts:
            c["elements"] += p.numel()
            c["bytes"] += p.numel() * p.element_size()
            c["largest"] = max(c["largest"], p.numel() * p.element_size())
        return self.inner.gather_to_host(parts, dst)


def _start(init_method: str, rank: int, world_size: int, device, timeout_s: float) -> None:
    """Start the default process group: NCCL when `device` is the card, gloo
    when it is the CPU.  init_method: "file://<path>" or
    "tcp://localhost:<port>".  A collective that waits longer than
    timeout_s fails instead of hanging."""
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is not None:   # "cuda:<rank>" on a multi-card host
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_data_group(init_method: str, rank: int, world_size: int,
                    device: str | torch.device = "cuda", timeout_s: float = 120.0) -> Group:
    """Start the default process group for rank `rank` of `world_size` and
    return it as the data `Group` (`_start`)."""
    _start(init_method, rank, world_size, device, timeout_s)
    return Group()


def make_ensemble_group(init_method: str, rank: int, world_size: int,
                        device: str | torch.device = "cuda", timeout_s: float = 120.0) -> Group:
    """Start the default process group for a replica layout (`EnsembleEngine`
    and `SimulationService` with `mesh=`): world_size ranks, each holding a
    block of K/world_size replicas or slots; the group's rank is the
    rank's ensemble coordinate."""
    _start(init_method, rank, world_size, device, timeout_s)
    return Group(name=ENSEMBLE)


class SweepGroups(NamedTuple):
    """One rank's groups of a 2-D (ensemble x data) layout: `data`, the d
    ranks sharing its block of replicas (every collective of the step), and
    `ensemble`, the e ranks at its data rank, one per block (the gathers of
    results after a run); `ensemble.rank` is the ensemble coordinate."""
    data: Group
    ensemble: Group


def make_sweep_groups(ensemble: int, data: int, init_method: str | None = None, rank: int = 0,
                      device: str | torch.device = "cuda", timeout_s: float = 120.0
                      ) -> SweepGroups:
    """The 2-D layout of e x d ranks (`DistributedEnsembleEngine`): rank r has
    ensemble coordinate r // d and data rank r % d.  Starts the default
    process group of e*d ranks when none is running (init_method, rank and
    device as `make_data_group`); an existing one must have e*d ranks.
    Every rank creates every row group and every column group, in the same
    order (`dist.new_group` is collective)."""
    if ensemble < 1 or data < 1:
        raise ValueError(f"sweep layout needs positive axis sizes, got {ensemble} x {data}")
    need = ensemble * data
    if not dist.is_initialized():
        if init_method is None:
            raise ValueError("no process group is running: pass init_method")
        _start(init_method, rank, need, device, timeout_s)
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"sweep layout needs {need} devices ({ensemble} x {data}), "
                         f"the process group has {world}")
    me = dist.get_rank()
    rows = [dist.new_group(list(range(c * data, (c + 1) * data))) for c in range(ensemble)]
    cols = [dist.new_group(list(range(j, need, data))) for j in range(data)]
    return SweepGroups(data=Group(rows[me // data], DATA),
                       ensemble=Group(cols[me % data], ENSEMBLE))


class LMGroups:
    """One rank's groups of the LM layout (port of the reference's
    `make_host_mesh` / `make_production_mesh` meshes): ranks numbered
    row-major over `axes` ((pod,) data, model), as the reference's
    `np.array(devices).reshape(...)` places devices.  `groups` maps a tuple
    of axes, in layout order, to the group of the ranks that share every
    other coordinate (its rank order is the row-major order over those
    axes): each single axis, the fsdp axes (pod, data) and the world.
    `shape` maps each axis to its size (what the spec functions of
    `sharding.rules` read), `coords` to this rank's (coordinate, size)."""

    def __init__(self, axes: Sequence[str], sizes: Sequence[int], rank: int,
                 groups: Dict[Tuple[str, ...], object]):
        self.axes, self.sizes, self.rank = tuple(axes), tuple(sizes), int(rank)
        self.groups = dict(groups)
        self.shape = dict(zip(self.axes, self.sizes))
        self.coords = coords_of(self.axes, self.sizes, self.rank)
        self.size = math.prod(self.sizes)
        self.world = self.groups[self.axes]
        self.device = self.world.device

    def group(self, axes: Sequence[str]):
        """The group of the ranks that differ only in `axes` (None for ())."""
        axes = tuple(a for a in self.axes if a in axes)
        if not axes:
            return None
        if axes not in self.groups:
            raise KeyError(f"the layout has no group over {axes}: {sorted(self.groups)}")
        return self.groups[axes]

    def counting(self) -> "LMGroups":
        """The same layout with every group wrapped in a `CountingGroup`
        (one wrapper for a group that serves two axis tuples)."""
        wrapped = {}
        groups = {k: wrapped.setdefault(id(g), CountingGroup(g, CountingGroup.LM_NAMES))
                  for k, g in self.groups.items()}
        return LMGroups(self.axes, self.sizes, self.rank, groups)

    def counts(self) -> Dict[str, dict]:
        """Each counting group's counts, keyed by its axes joined with "+"."""
        seen, out = set(), {}
        for k, g in self.groups.items():
            if isinstance(g, CountingGroup) and id(g) not in seen:
                seen.add(id(g))
                out["+".join(k)] = {n: dict(c) for n, c in g.counts.items()}
        return out

    def reset_counts(self) -> None:
        for g in self.groups.values():
            if isinstance(g, CountingGroup):
                g.reset()


def _axis_tuples(axes: Tuple[str, ...]) -> List[Tuple[str, ...]]:
    """The axis tuples a layout has groups for: each axis, the fsdp axes
    (pod, data) when there is a pod axis, and the world."""
    out = [(a,) for a in axes]
    if POD in axes:
        out.append((POD, DATA))
    return out + ([axes] if len(axes) > 1 else [])


def _members(axes: Tuple[str, ...], sizes: Tuple[int, ...], over: Tuple[str, ...]):
    """Every group of ranks over `over`: lists of global ranks that share
    every other coordinate, sorted."""
    out = {}
    for r in range(math.prod(sizes)):
        c = coords_of(axes, sizes, r)
        out.setdefault(tuple(c[a][0] for a in axes if a not in over), []).append(r)
    return list(out.values())


def shape_layout(sizes: Sequence[int], rank: int = 0) -> LMGroups:
    """The layout of `sizes` ((data, model) or (pod, data, model)) seen from
    `rank`, of `ShapeGroup`s: spec arithmetic only, no collective."""
    axes = (POD, DATA, MODEL) if len(sizes) == 3 else (DATA, MODEL)
    coords = coords_of(axes, sizes, rank)
    groups = {}
    for over in _axis_tuples(axes):
        index, size = block_of(over, coords)
        groups[over] = ShapeGroup(size, index, name="+".join(over))
    return LMGroups(axes, sizes, rank, groups)


def meta_layout(sizes: Sequence[int], rank: int = 0) -> LMGroups:
    """`shape_layout(sizes, rank)` with every group a `MetaGroup` (of the
    same size, rank and name) and the layout's device meta: the layout a
    dry run traces a step on."""
    lay = shape_layout(sizes, rank)
    return LMGroups(lay.axes, lay.sizes, lay.rank, {
        k: MetaGroup(g.size, g.rank, g.name) for k, g in lay.groups.items()})


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> LMGroups:
    """The reference's production layout, 16 x 16 (data, model) or 2 x 16 x
    16 (pod, data, model), seen from `rank`: `ShapeGroup`s, for the spec
    arithmetic of 256 or 512 ranks (no collective)."""
    return shape_layout((2, 16, 16) if multi_pod else (16, 16), rank)


def make_host_mesh(data: int = 1, model: int = 1, init_method: str | None = None,
                   rank: int = 0, device: str | torch.device = "cuda",
                   timeout_s: float = 120.0) -> LMGroups:
    """The LM layout of data x model ranks: rank r has data coordinate
    r // model and model coordinate r % model.  Starts the default process
    group of data*model ranks when none is running (init_method, rank and
    device as `make_data_group`; NCCL on the card, gloo on the CPU); an
    existing one must have data*model ranks.  Every rank creates every
    group (each axis's, the world is the default group), in the same order
    (`dist.new_group` is collective)."""
    if data < 1 or model < 1:
        raise ValueError(f"LM layout needs positive axis sizes, got {data} x {model}")
    need = data * model
    if not dist.is_initialized():
        if init_method is None:
            raise ValueError("no process group is running: pass init_method")
        _start(init_method, rank, need, device, timeout_s)
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"LM layout needs {need} ranks ({data} x {model}), "
                         f"the process group has {world}")
    axes, sizes, me = (DATA, MODEL), (data, model), dist.get_rank()
    groups = {}
    for over in _axis_tuples(axes):
        if over == axes:
            groups[over] = Group(None, "+".join(over))
            continue
        for members in _members(axes, sizes, over):
            pg = dist.new_group(members)
            if me in members:
                groups[over] = Group(pg, "+".join(over))
    return LMGroups(axes, sizes, me, groups)
