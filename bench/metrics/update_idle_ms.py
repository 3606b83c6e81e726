"""Device idle milliseconds per network update: the idle gaps of the traced
chunks whose ending operation was launched inside an `update.connectivity`
range (the `idle_gaps` method of `harness/profile.py`), over the number of
those ranges.  The time the update's host code keeps the card waiting."""
import bisect

from bench.harness import profile as pr

UNIT = "ms"
LAYER = "connectivity update (core/engine.py, core/synapses.py)"
MOVES = "update_ms"
RANGE = "update.connectivity"


def read(ctx):
    rec = ctx["profile"]
    spans = sorted((r for r in rec["ranges"] if r[0] == RANGE), key=lambda r: r[1])
    if not spans or not rec["ops"]:
        return None
    starts = [s[1] for s in spans]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= spans[i][2]
    idle = sum(gap for _, _, gaps in pr._timeline(rec) for gap, op in gaps
               if op is not None and inside(op[3]))
    return idle / 1e6 / len(spans)
