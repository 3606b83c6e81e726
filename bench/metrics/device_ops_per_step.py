"""Device operations (kernels, copies, memsets) per activity step, in the
traced run's 99-step chunks: what the ensemble driver launches for one
batched step of all K replicas.  Fewer launches a step is what a fused
step would show."""
from bench.harness import profile as pr

UNIT = "ops"
LAYER = "ensemble driver (core/ensemble.py)"
MOVES = "activity_step_ms"


def read(ctx):
    rec = ctx["profile"]
    steps = sum(s for kind, s in rec["chunk_steps"] if kind == "bench.activity")
    ops = pr.chunk_ops(rec, "bench.activity")
    if not steps or not ops:
        return None
    return len(ops) / steps
