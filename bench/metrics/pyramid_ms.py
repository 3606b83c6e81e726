"""Device milliseconds of `update.pyramid` per replica-update: the upward
pass (the full segment-sum pyramid with order-p expansions for FMM, the
dendrite counts and centroids alone for Barnes-Hut)."""
from bench.harness import profile as pr

UNIT = "ms"
LAYER = "pyramid (core/octree.py, core/expansions.py)"
MOVES = "update_ms"


def read(ctx):
    rec = ctx["profile"]
    dev = pr.range_device_s(rec, ["update.pyramid"])
    if not dev or not rec["replica_updates"]:
        return None
    return dev * 1e3 / rec["replica_updates"]
