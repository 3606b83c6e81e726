"""Share of its bandwidth roofline that the `m2l_separable` kernel reaches
in the FMM descent, in %.

A pair reads its source box's 64 moments, its target's 64 Hermite
coefficients and 3 offsets and writes one float: 528 B, each byte counted
once.  Its 1,647 float32 operations take far less time at the float32 peak
than those bytes at the HBM peak, so bytes bound it.  The Hermite and the
Taylor tier both run through the kernel.  Pairs per launch come from the
port's counters (`kernels.m2l_separable.pairs` over `.launches`, both of
the traced intervals); the launches and their device time from the profile
(operations named `m2l_separable_kernel` launched in the traced chunks).
Share = pairs x 528 B / 3.35 TB/s over that time."""
from bench.harness import counters, peaks
from bench.harness import profile as pr

UNIT = "%"
LAYER = "search (core/traversal.py, core/barnes_hut.py)"
MOVES = "update_ms"
KERNEL = "m2l_separable_kernel"
BYTES_PER_PAIR = (64 + 64 + 3 + 1) * 4
FLOPS_PER_PAIR = 1647


def read(ctx):
    c = counters.counts()
    per_launch = counters.ratio(c.get("kernels.m2l_separable.pairs", 0),
                                c.get("kernels.m2l_separable.launches", 0))
    ops = [o for o in pr.chunk_ops(ctx["profile"]) if KERNEL in o[0]]
    dev = sum(o[2] for o in ops) / 1e9
    if not per_launch or not dev:
        return None
    pairs = per_launch * len(ops)
    least = max(pairs * BYTES_PER_PAIR / peaks.HBM_BYTES_PER_S,
                pairs * FLOPS_PER_PAIR / peaks.FP32_FLOP_PER_S)
    return 100.0 * least / dev
