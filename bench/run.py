#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload fmm-sweep16-steady --seed 7 --seconds 40 --trace 0

From the root of a checkout: find the cell's pieces by name
(`harness/spec.py`), hand them to the module of the configuration's
system (`systems/<system>.py`), which sets up, measures the window of
`--seconds` seconds or more and compares what it produced with the plain
reference, and print, as the last line of standard output, one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones, each read by its own
`metrics/<name>.py`), `device`, with `--trace 1` a `breakdown`, and last
`checks`, each compared number beside its limit (also the last lines of
standard error).

It needs a CUDA card (as many as the cell asks for) and the port's package
under `src/`; it exits with a non-zero code and prints no result without
them, or if JAX or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

_STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from bench.harness import profile as pr  # noqa: E402
from bench.harness import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc), or the
    time this module began to load where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _STARTED


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (`repro_torch` is not `repro`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             started: float | None = None) -> dict:
    """One run of `cell`: set-up, the window, the comparison.  Returns the
    result object (without printing)."""
    dev = torch.device(device)
    sut = spec.system_module(cell.config["system"], cell.root)
    w = sut.measure(cell, seed, seconds, trace, dev, started)
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit(f"bench: the run loaded {loaded} (jax, jaxlib, flax or the JAX "
                         f"package); no result")
    metrics = {}
    if trace:
        ctx = sut.context(w)
        for m in cell.per_layer:
            value = spec.metric_module(m["name"], cell.root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = sut.end_to_end(w)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    verdict = sut.judge(w, seed, dev)
    if dev.type == "cuda":
        kind, count = torch.cuda.get_device_name(dev), cell.chips
    else:
        kind, count = "cpu", 1
    result = {
        "correct": verdict["failed"] == 0 and verdict["checked"] > 0,
        "attempted": verdict["attempted"],
        "failed": verdict["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": count, "memory_peak_bytes": w.peak_bytes},
    }
    if trace and w.profile is not None:
        result["device"]["busy_s"] = pr.busy_s(w.profile)
        result["device"]["window_s"] = pr.window_s(w.profile)
        result["breakdown"] = {"device_ops": pr.top_ops(w.profile),
                               "idle_gaps": pr.idle_gaps(w.profile)}
    result["checks"] = {name: {"value": value, "limit": verdict["limits"][name]}
                        for name, value in verdict["worst"].items()}
    return result


def card_note() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    started = process_start()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("bench: no CUDA card (torch.cuda.is_available() is false); no result",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: the cell needs {cell.chips} cards, {torch.cuda.device_count()} seen; "
              "no result", file=sys.stderr)
        return 2
    # One process with one CPU thread for PyTorch's own pool: the timed path
    # runs on the card and the host's Python thread, and idle pool threads
    # would only compete with that thread for the shared host's cores.
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", started)
    print(f"bench: {card_note()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"bench check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
