"""Device milliseconds of `step.synaptic_input` per activity step: spike
propagation over the K edge tables of the batched step."""
from bench.harness import profile as pr

UNIT = "ms"
LAYER = "activity step (core/engine.py, core/synapses.py)"
MOVES = "activity_step_ms"


def read(ctx):
    rec = ctx["profile"]
    dev = pr.range_device_s(rec, ["step.synaptic_input"])
    if not dev or not rec["activity_steps"]:
        return None
    return dev * 1e3 / rec["activity_steps"]
