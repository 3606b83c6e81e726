"""Device operations (kernels, copies, memsets) launched inside
`update.connectivity` ranges in the traced chunks, per range: what one
network's connectivity update launches.  Fewer launches an update is what a
fused or batched update would show."""
from bench.harness import profile as pr

UNIT = "ops"
LAYER = "connectivity update (core/engine.py, core/synapses.py)"
MOVES = "update_ms"
RANGE = "update.connectivity"


def read(ctx):
    rec = ctx["profile"]
    spans = [r for r in rec["ranges"] if r[0] == RANGE]
    if not spans or not rec["ops"]:
        return None
    return len(pr._launched_in(pr.chunk_ops(rec), spans)) / len(spans)
