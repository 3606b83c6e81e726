"""Synapses deleted per network update (the excess of shrunk elements, both
sides): the port's counters `update.deleted` over `update.networks`."""
from bench.harness import counters

UNIT = "synapses"
LAYER = "connectivity update (core/engine.py, core/synapses.py)"
MOVES = "update_ms"


def read(ctx):
    c = counters.counts()
    if "update.networks" not in c:
        return None
    return counters.ratio(c.get("update.deleted", 0), c["update.networks"])
