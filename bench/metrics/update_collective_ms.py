"""Device milliseconds of the NCCL kernels per network update: the
NCCL kernels (`ncclDevKernel_*`) launched inside the collectives' `dist.*` ranges
in the traced `bench.update` chunks that ran inside an
`update.connectivity` range (the update's degree merges, gathers,
descent-map merges, routed pyramid exchange and request exchange), over
the number of those ranges.  Rank 0's trace."""
from bench.harness import links
from bench.harness import profile as pr

UNIT = "ms"
LAYER = "collectives (launch/mesh.py, core/distributed.py)"
MOVES = "update_ms"
RANGE = "update.connectivity"


def read(ctx):
    rec = ctx.get("profile")
    if not rec:
        return None
    updates = [r for r in rec["ranges"] if r[0] == RANGE]
    ops = pr._launched_in(links.collective_ops(rec, "bench.update"), updates) if updates else []
    if not ops:
        return None
    return sum(o[2] for o in ops) / 1e6 / len(updates)
