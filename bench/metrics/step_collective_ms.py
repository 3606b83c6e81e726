"""Device milliseconds of the NCCL kernels per activity step: the
NCCL kernels (`ncclDevKernel_*`) launched inside the collectives' `dist.*` ranges
in the traced `bench.activity` chunks (the distributed step's all-reduce of
the synaptic-input partials and all-gathers of spikes and calcium), over
those chunks' steps.  Rank 0's trace."""
from bench.harness import links

UNIT = "ms"
LAYER = "collectives (launch/mesh.py, core/distributed.py)"
MOVES = "activity_step_ms"
KIND = "bench.activity"


def read(ctx):
    rec = ctx.get("profile")
    if not rec:
        return None
    steps = sum(s for k, s in rec["chunk_steps"] if k == KIND)
    ops = links.collective_ops(rec, KIND)
    if not ops or not steps:
        return None
    return sum(o[2] for o in ops) / 1e6 / steps
