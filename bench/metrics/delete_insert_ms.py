"""Device milliseconds of `update.delete_excess` and `update.conflicts_insert`
per replica-update: the edge-table work of the connectivity update."""
from bench.harness import profile as pr

UNIT = "ms"
LAYER = "connectivity update (core/engine.py, core/synapses.py)"
MOVES = "update_ms"


def read(ctx):
    rec = ctx["profile"]
    dev = pr.range_device_s(rec, ["update.delete_excess", "update.conflicts_insert"])
    if not dev or not rec["replica_updates"]:
        return None
    return dev * 1e3 / rec["replica_updates"]
