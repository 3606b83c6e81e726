"""Of the (source box, target child) pairs that the FMM descent's three tiers
(Alg. 2: direct, Hermite, Taylor) evaluated, the share whose value the blend
kept, in %: the port's counters `search.pairs.<tier>.used` over
`search.pairs.<tier>.evaluated`, summed over the tiers.  Each tier runs on
every pair of a level where it runs, so a third is the most the paper's
blend can keep on levels with valid expansions."""
from bench.harness import counters

UNIT = "%"
LAYER = "search (core/traversal.py, core/barnes_hut.py)"
MOVES = "update_ms"
TIERS = ("direct", "hermite", "taylor")


def read(ctx):
    c = counters.counts()
    total = lambda what: sum(c.get(f"search.pairs.{t}.{what}", 0) for t in TIERS)
    return counters.ratio(total("used"), total("evaluated"), 100.0)
