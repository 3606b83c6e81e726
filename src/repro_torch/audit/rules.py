"""The rules the auditor holds a `tracer.Trace` to (the port's R1-R4), and
the build check.

R1  records      a float reduction or accumulation on the record path
                 (a frame named `records`) happens only inside a
                 `synapses.det_sum` tree, so the means and the deviation
                 are the single-device run's sums bit for bit.
R2  collectives  every collective goes through a group named in
                 `allowed_groups` (the data group of a distributed step;
                 none at all for the ensemble and the served round), and
                 no `torch.distributed` collective is made outside
                 `launch/mesh.py`'s groups.
R3  deletion     a gather of at least `min_size` elements (the edge table)
                 happens only inside a connectivity update that has an
                 excess to delete.
R4  order        no float accumulation (`index_add_`, `scatter_add_`,
                 `index_put_(accumulate=True)`, ...) and no float
                 reduction over an extent in `sizes` (a sharded or padded
                 axis).  The sanctioned helpers, `octree._run_sums` and
                 `synapses.det_sum`, add by fixed halving trees of slices
                 and make neither; anything else is named in the entry's
                 allowlist with its reason (the m2m leaf level's
                 `torch.sum`, which `_run_sums` runs when asked for an
                 unordered sum, among them).
BUILD            every kernel on a bitwise path is compiled with
                 `--fmad=false` (`check_build_source` reads kernels/build.py).
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.audit.report import Finding

RECORD_FUNCTION = "records"
DET_SUM = "repro_torch.core.synapses.det_sum"


def _where(frames: tuple) -> str:
    return " > ".join(f.replace("repro_torch.", "") for f in frames[-3:])


def _inside(frames: tuple, names) -> bool:
    return any(f in names for f in frames)


def r1_records(entry: str, trace, cfg: dict) -> list:
    out = []
    for op in trace.ops:
        if not op.is_float or not (op.accumulates or op.extents):
            continue
        on_path = any(f.rsplit(".", 1)[1] == RECORD_FUNCTION for f in op.frames)
        if on_path and not _inside(op.frames, (DET_SUM,)):
            out.append(Finding("R1", entry, f"float {op.name} on the record path outside "
                               "synapses.det_sum: the record would not be the single-device "
                               "run's sum", _where(op.frames)))
    return out


def r2_collectives(entry: str, trace, cfg: dict) -> list:
    allowed = tuple(cfg.get("allowed_groups", ()))
    out = []
    for c in trace.collectives:
        if c.group not in allowed:
            out.append(Finding("R2", entry, f"{c.kind} on the {c.group!r} group (allowed: "
                               f"{allowed or 'none'}): replicas or slots would communicate",
                               _where(c.frames)))
    for name, *frames in trace.naked:
        out.append(Finding("R2", entry, f"naked torch.distributed.{name} outside the "
                           "launch.mesh groups", _where(tuple(frames))))
    return out


def r3_deletion(entry: str, trace, cfg: dict) -> list:
    size = int(cfg["min_size"])
    return [Finding("R3", entry, f"a {c.elements}-element gather (the edge table is {size}) "
                    f"in {'an update without excess' if c.excess is False else 'no update'}",
                    _where(c.frames))
            for c in trace.collectives
            if c.kind == "gather" and c.elements >= size and not c.excess]


def r4_order(entry: str, trace, cfg: dict) -> list:
    sizes = set(cfg.get("sizes", ()))
    allow = dict(cfg.get("allowlist", ()))
    out = []
    for op in trace.ops:
        if not op.is_float or _inside(op.frames, allow):
            continue
        if op.accumulates:
            out.append(Finding("R4", entry, f"float {op.name} (an unordered accumulation)",
                               _where(op.frames)))
        elif sizes & set(op.extents):
            out.append(Finding("R4", entry, f"float {op.name} over extents {op.extents} (a "
                               "sharded or padded axis) outside the fixed-order helpers",
                               _where(op.frames)))
    return out


RULES = {"R1": r1_records, "R2": r2_collectives, "R3": r3_deletion, "R4": r4_order}


def check_build_source(source: str, where: str = "kernels/build.py") -> list:
    """BUILD: the nvcc flags (a list literal holding "-O3" or "-arch") must
    hold `--fmad=false`: without it nvcc contracts a*b + c into one FMA, and
    the kernels no longer round as their plain versions do."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, (ast.List, ast.Tuple)):
            items = [e.value for e in node.elts
                     if isinstance(e, ast.Constant) and isinstance(e.value, str)]
            if any(i == "-O3" or i.startswith("-arch") for i in items):
                if "--fmad=false" in items:
                    return []
                return [Finding("BUILD", where, "nvcc flags lack --fmad=false: the kernels "
                                "would fuse multiplies and adds the plain versions round "
                                "apart", f"{where}:{node.lineno}")]
    return [Finding("BUILD", where, "no nvcc flag list found")]


def check_build(root: Path = None) -> list:
    root = root or Path(__file__).resolve().parent.parent
    return check_build_source((root / "kernels" / "build.py").read_text())
