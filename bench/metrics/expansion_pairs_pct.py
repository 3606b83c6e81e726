"""Of the FMM descent's pairs on levels with valid expansions, the share
whose value came from an expansion (the Hermite or the Taylor tier), in %:
`search.pairs.hermite.used` + `search.pairs.taylor.used` over
`search.pairs.hermite.evaluated` (the Hermite tier runs on exactly those
levels' pairs).  How much of the scoring needs the expansions that the
pyramid builds."""
from bench.harness import counters

UNIT = "%"
LAYER = "search (core/traversal.py, core/barnes_hut.py)"
MOVES = "update_ms"


def read(ctx):
    c = counters.counts()
    used = c.get("search.pairs.hermite.used", 0) + c.get("search.pairs.taylor.used", 0)
    return counters.ratio(used, c.get("search.pairs.hermite.evaluated", 0), 100.0)
