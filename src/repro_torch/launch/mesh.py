"""The data axis of the distributed engine over `torch.distributed` (port of
`repro/launch/mesh.py`'s `make_data_mesh`).

The JAX engine names a mesh axis in its collectives; the port runs one
process per rank and hands the engine a `Group`, whose three methods are
the collectives the reference's helpers take as callables:

    gather(x)       lax.all_gather(x, tiled=True)   dist.all_gather_into_tensor
    merge(x)        lax.psum(x)                     dist.all_reduce(SUM)
    scatter_sum(x)  lax.psum_scatter(x, dim 0)      dist.reduce_scatter_tensor

A bool tensor travels as uint8.  `make_data_group` starts the process
group: NCCL for the card, gloo for the CPU, and no fallback from one to the
other.  `CountingGroup` records the calls and bytes of each collective (the
census and chip_smoke.py read it).  `ShapeGroup` knows its size only, for
the static counters of a layout with more ranks than there are processes.
"""
from __future__ import annotations

import datetime
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch import device as _device


class Group:
    """One rank's view of a `torch.distributed` process group (None = the
    default group)."""

    def __init__(self, pg=None):
        self.pg = pg
        self.rank = dist.get_rank(pg)
        self.size = dist.get_world_size(pg)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated along dim 0, in rank order."""
        src = x.contiguous().view(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        out = src.new_empty((self.size * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=self.pg)
        return out.view(torch.bool) if x.dtype == torch.bool else out

    def merge(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x (exact for integers, and for floats
        where at most one rank holds a value other than zero)."""
        out = x.clone()
        dist.all_reduce(out, group=self.pg)
        return out

    def scatter_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x: (size, ...) -> (...): block `rank` of the sum over ranks."""
        out = x.new_empty(tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.reshape((-1,) + tuple(x.shape[2:])).contiguous(),
                                   group=self.pg)
        return out


class ShapeGroup:
    """A group of `size` ranks seen from `rank` that performs no collective
    (the static counters of `DistributedPlasticityEngine`)."""

    def __init__(self, size: int, rank: int = 0):
        self.size, self.rank = int(size), int(rank)

    def _none(self, x):
        raise RuntimeError("ShapeGroup performs no collectives")

    gather = merge = scatter_sum = _none


class CountingGroup:
    """A group that counts, per collective, its calls and the elements and
    bytes of the whole vector it moves: a gather's output, a merge's input,
    a scatter_sum's input."""

    NAMES = ("gather", "merge", "scatter_sum")

    def __init__(self, inner):
        self.inner = inner
        self.rank, self.size = inner.rank, inner.size
        self.reset()

    def reset(self) -> None:
        self.counts: Dict[str, Dict[str, int]] = {
            k: {"calls": 0, "elements": 0, "bytes": 0} for k in self.NAMES}

    def _count(self, name: str, t: torch.Tensor) -> None:
        c = self.counts[name]
        c["calls"] += 1
        c["elements"] += t.numel()
        c["bytes"] += t.numel() * t.element_size()

    def gather(self, x):
        out = self.inner.gather(x)
        self._count("gather", out)
        return out

    def merge(self, x):
        self._count("merge", x)
        return self.inner.merge(x)

    def scatter_sum(self, x):
        self._count("scatter_sum", x)
        return self.inner.scatter_sum(x)


def make_data_group(init_method: str, rank: int, world_size: int,
                    device: str | torch.device = "cuda", timeout_s: float = 120.0) -> Group:
    """Start the default process group for rank `rank` of `world_size` and
    return it as a `Group`: NCCL when `device` is the card, gloo when it is
    the CPU.  init_method: "file://<path>" or "tcp://localhost:<port>".  A
    collective that waits longer than timeout_s fails instead of hanging."""
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is not None:   # "cuda:<rank>" on a multi-card host
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Group()
