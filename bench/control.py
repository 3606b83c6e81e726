#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, for one cell.

    python3 bench/control.py --workload fmm-sweep16-steady --seconds 12 --seeds 11 12 13

For each seed, in one process: set-up and a short window at the cell's own
load (the system's `measure`), then each checked interval compared twice, with the
program's output (the sound reading) and with the reference computed in
bfloat16 in the program's place (the control, which has to read over a
limit).  Prints one JSON line per seed with the worst reading of each
number on either side, and a last line with the largest sound reading and
the smallest control reading of each number.  The benchmark's own runs do
not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT), str(ROOT / "bench")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from bench.harness import check as ck  # noqa: E402
from bench.harness import spec  # noqa: E402


def readings(cell: spec.Cell, seed: int, seconds: float, device="cuda") -> dict:
    """{"sound": worst readings, "control": worst readings, "synapses": the
    program's synapse count at each checked interval's end}."""
    sut = spec.system_module(cell.config["system"], cell.root)
    w = sut.measure(cell, seed, seconds, False, torch.device(device))
    sound = sut.compare(w, seed, device)
    control = sut.compare(w, seed, device, control=True)
    worst = lambda rs: {k: max(r[k] for r in rs) for k in ck.NUMBERS}
    return {"seed": seed, "intervals": len(w.kept), "checked": len(sound),
            "sound": worst(sound), "control_min": {k: min(r[k] for r in control)
                                                   for k in ck.NUMBERS},
            "synapses": [int(w.kept[i].records[-1, 2]) for i in range(len(w.kept))]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    rows = []
    for seed in args.seeds:
        rows.append(readings(cell, seed, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "workload": args.workload, "seeds": args.seeds,
        "sound_max": {k: max(r["sound"][k] for r in rows) for k in ck.NUMBERS},
        "control_min": {k: min(r["control_min"][k] for r in rows) for k in ck.NUMBERS},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
