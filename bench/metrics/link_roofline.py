"""Share of the link's published peak that the activity step's collectives
reach, in %: the step's bus bytes on rank 0 (NCCL's ring factors over the
`dist.<op>.bytes` counters, `harness/links.py`) over the device time of
the NCCL kernels launched inside the `dist.*` ranges of the traced
`bench.activity` chunks, over the NVLink peak in one direction."""
from bench.harness import links

UNIT = "%"
LAYER = "collectives (launch/mesh.py, core/distributed.py)"
MOVES = "activity_step_ms"
KIND = "bench.activity"


def read(ctx):
    counts, rec = ctx.get("counts"), ctx.get("profile")
    if not counts or not rec:
        return None
    bus = links.ring_bus_bytes(counts.get(KIND, {}), int(ctx.get("ranks", 1)))
    dev = sum(o[2] for o in links.collective_ops(rec, KIND)) / 1e9
    if not bus or not dev:
        return None
    return 100.0 * bus / dev / links.NVLINK_BYTES_PER_S
