"""Share of the profiled chunks' host time in which no device operation ran,
in %.  The profiler stretches the host's time, so this reads higher than
an untraced run would: it is the traced run's idle share."""
from bench.harness import profile as pr

UNIT = "%"
LAYER = "device"
MOVES = "neuron_steps_per_s"


def read(ctx):
    rec = ctx["profile"]
    wall = pr.window_s(rec)
    if not wall or not rec["ops"]:
        return None
    return 100.0 * (1.0 - pr.busy_s(rec) / wall)
