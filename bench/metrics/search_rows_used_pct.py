"""Of the neuron rows that the leaf resolve evaluates (every row, FMM and
Barnes-Hut alike), the share it returns a partner for, in %: the port's
counters `search.rows_found` over `search.rows`."""
from bench.harness import counters

UNIT = "%"
LAYER = "search (core/traversal.py, core/barnes_hut.py)"
MOVES = "update_ms"


def read(ctx):
    c = counters.counts()
    return counters.ratio(c.get("search.rows_found", 0), c.get("search.rows", 0), 100.0)
