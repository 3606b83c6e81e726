"""Share of its bandwidth roofline that the `step.neurons` layer reaches.

The layer (`core/msp.py` `step_neurons`: the `msp_update` kernel and the
growth curve) must read, per row, x, refrac, calcium, the synaptic input,
the spike uniform and both element counts (7 x 4 B) and write x, refrac,
calcium and both element counts (5 x 4 B) and `spiked` (1 B): 49 B a row,
each byte counted once (the `msp_update` kernel's share is 33 B).  Its
arithmetic, some 30 float32 operations a row, needs far less time at the
float32 peak than those bytes at the HBM peak, so bytes bound it.  The
count is of what the layer's inputs and outputs need, not of what its
kernels move, so a kernel that replaces them is read on the same
yardstick.  Share = rows x 49 B / 3.35 TB/s over the layer's device time
per step, in %."""
from bench.harness import peaks
from bench.harness import profile as pr

UNIT = "%"
LAYER = "kernels (kernels/msp_update.py, core/msp.py)"
MOVES = "activity_step_ms"
BYTES_PER_ROW = 7 * 4 + 5 * 4 + 1
FLOPS_PER_ROW = 30


def read(ctx):
    rec = ctx["profile"]
    dev = pr.range_device_s(rec, ["step.neurons"])
    if not dev or not rec["activity_steps"]:
        return None
    per_step = dev / rec["activity_steps"]
    least = max(rec["rows"] * BYTES_PER_ROW / peaks.HBM_BYTES_PER_S,
                rec["rows"] * FLOPS_PER_ROW / peaks.FP32_FLOP_PER_S)
    return 100.0 * least / per_step
