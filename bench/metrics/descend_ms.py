"""Device milliseconds of the descent per replica-update: `traversal.descend`
(FMM: the tiered box-to-box descent with `m2l_separable`) or `bh.descend`
(Barnes-Hut: every neuron's own descent)."""
from bench.harness import profile as pr

UNIT = "ms"
LAYER = "search (core/traversal.py, core/barnes_hut.py)"
MOVES = "update_ms"


def read(ctx):
    rec = ctx["profile"]
    dev = pr.range_device_s(rec, ["traversal.descend", "bh.descend"])
    if not dev or not rec["replica_updates"]:
        return None
    return dev * 1e3 / rec["replica_updates"]
