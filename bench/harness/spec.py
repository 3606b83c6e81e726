"""Finding the benchmark's pieces by name.

`BENCHMARK.json` at the root of the checkout names every cell, configuration
and metric.  Each piece is a file of its own, found by its name alone:

    configuration  bench/configs/<config>.json
    system         bench/systems/<system>.py   (named by the configuration)
    traffic mix    bench/traffic/<traffic>.json
    start state    bench/starts/<generator>.py (named by the mix's `start`)
    metric         bench/metrics/<metric>.py   (per-layer metrics)

so a later change adds a configuration, a mix or a metric with new files
and new entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, NamedTuple

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class Cell(NamedTuple):
    root: Path             # the checkout the pieces were found in
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict           # the configuration file's contents
    traffic: dict          # the traffic file's contents
    start: ModuleType      # the mix's start generator (`draw`)
    end_to_end: List[dict]  # the entries of the metrics this cell reports untraced
    per_layer: List[dict]   # ... and traced


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` with its configuration, traffic and metrics."""
    bm = benchmark(root)
    cells = {w["name"]: w for w in bm["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bm["configs"]}
    cfg_entry = configs[w["config"]]
    e2e = [m for m in bm["end_to_end"] if _covers(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bm["per_layer"] if _covers(m, name) and m["moves"] in reported]
    traffic = load_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    return Cell(root=root, name=name, chips=int(w["chips"]), config_name=w["config"],
                traffic_name=w["traffic"], config=load_json(root / cfg_entry["file"]),
                traffic=traffic, start=_module("starts", traffic["start"]["generator"], root),
                end_to_end=e2e, per_layer=per_layer)


def _module(kind: str, name: str, root: Path) -> ModuleType:
    """bench/<kind>/<name>.py, loaded by its path (a name may hold '.')."""
    path = root / "bench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r} has no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system_module(name: str, root: Path = ROOT) -> ModuleType:
    """The module that sets up, measures and judges a configuration's
    system: bench/systems/<name>.py."""
    return _module("systems", name, root)


def metric_module(name: str, root: Path = ROOT) -> ModuleType:
    """The reader of per-layer metric `name`: bench/metrics/<name>.py."""
    return _module("metrics", name, root)
