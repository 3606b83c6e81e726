"""The published peak of the link between the cards of one host.

NVIDIA H100 SXM5 (NVIDIA's data sheet): fourth-generation NVLink, 18 links
of 25 GB/s each way, 900 GB/s in both directions together, so 450e9 B/s
in one direction.  On a host whose cards are joined all to all through
NVSwitch (`nvidia-smi topo -m` reads NV18 between every pair), a rank's
collective traffic can use all of it.  A roofline share of the link is
stated against this, with the topology beside it.  Also the arithmetic
the collectives' readers share: which device operations are the NCCL
kernels of the collectives, and their bus bytes.
"""
from bench.harness import profile as pr

NVLINK_BYTES_PER_S = 450e9      # one direction, per card


def ring_bus_bytes(counts: dict, ranks: int) -> float:
    """NCCL's bus bytes of a rank's collectives from the `dist.<op>.bytes`
    counters (`launch/mesh.py`'s `Group`): an all-reduce of S bytes moves
    2(p - 1)/p S over each link direction, an all-gather or a
    reduce-scatter whose whole vector is S moves (p - 1)/p S, an
    all-to-all of S moves (p - 1)/p S."""
    p = ranks
    if p < 2:
        return 0.0
    f = (p - 1) / p
    return (2 * f * counts.get("dist.merge.bytes", 0)
            + 2 * f * counts.get("dist.reduce.bytes", 0)
            + 2 * f * counts.get("dist.grad_sum.bytes", 0)
            + f * counts.get("dist.gather.bytes", 0)
            + f * counts.get("dist.scatter_sum.bytes", 0)
            + f * counts.get("dist.all_to_all.bytes", 0))


def is_nccl_kernel(name: str) -> bool:
    """An NCCL kernel (`ncclDevKernel_*`, `ncclKernel_*`), not the profiler's
    device-side annotation of the same collective (`nccl:all_reduce`), which
    spans the kernel and would count it twice."""
    return name.startswith("nccl") and not name.startswith("nccl:")


def collective_ops(rec: dict, chunk_kind: str, inside: str = "dist."):
    """The NCCL kernels launched in the chunks of `chunk_kind` inside ranges
    whose names start with `inside` (`launch/mesh.py` runs every collective
    in a `dist.<op>` range)."""
    spans = [r for r in rec["ranges"] if r[0].startswith(inside)]
    if not spans:
        return []
    ops = [o for o in pr.chunk_ops(rec, chunk_kind) if is_nccl_kernel(o[0])]
    return pr._launched_in(ops, spans)
