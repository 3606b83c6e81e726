"""Source lint of the port (stdlib only: nothing is imported or run).

Two checks, each honouring a per-line `# audit: ok` pragma:

* host syncs in the step loop: `.item()`, `.cpu()`, `.tolist()`,
  `float(...)` and `time.*` calls in `core/` and `kernels/` (but
  `core/analysis.py`, the offline network report).  Each one makes the host
  wait for the card, or brings host time into a run.  A line that computes
  with host values (configs, numpy tables, a replicated predicate the
  schedule needs) says so with the pragma.
* naked collectives: a `torch.distributed` collective anywhere in the
  package but `launch/mesh.py`.  Every other module gets its collectives
  through a `Group` (gather, merge, reduce, scatter_sum, all_to_all,
  gather_objects, gather_to_host), so rule R2 sees each one and the group it was made on.
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.audit.report import Finding

PRAGMA = "# audit: ok"
STEP_LOOP_DIRS = ("core", "kernels")
HOST_SIDE = ("core/analysis.py",)
COLLECTIVES_MODULE = "launch/mesh.py"
HOST_SYNC_ATTRS = frozenset({"item", "cpu", "tolist"})
COLLECTIVE_NAMES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "broadcast", "broadcast_object_list",
    "all_to_all", "all_to_all_single", "send", "recv", "isend", "irecv", "barrier",
    "gather", "scatter", "reduce", "gather_object", "scatter_object_list",
    "batch_isend_irecv", "monitored_barrier"})
DIST_ALIASES = ("dist", "distributed")


def package_root() -> Path:
    """The directory of the `repro_torch` package."""
    return Path(__file__).resolve().parent.parent


def _chain(node: ast.AST) -> list:
    """`torch.distributed.all_reduce` -> ["torch", "distributed", "all_reduce"]."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def lint_source(source: str, module: str, step_loop: bool = True,
                collectives_allowed: bool = False) -> list:
    """Lint one module's source; `module` is the name reported.  step_loop:
    apply the host-sync check; collectives_allowed: skip the
    naked-collective check (launch/mesh.py)."""
    tree = ast.parse(source)
    lines = source.splitlines()
    ok = lambda n: 0 < n <= len(lines) and PRAGMA in lines[n - 1]
    found = []

    def flag(node, msg):
        if not ok(node.lineno):
            found.append(Finding("AST", module, msg, f"{module}:{node.lineno}"))

    dist_names = set()      # collectives imported by name from torch.distributed
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "torch.distributed":
            dist_names |= {a.asname or a.name for a in node.names if a.name in COLLECTIVE_NAMES}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Name):
            if step_loop and func.id == "float":
                flag(node, "float(...) in the step loop makes the host wait for the card; "
                           f"keep the value on the device, or mark host math with `{PRAGMA}`")
            elif func.id in dist_names and not collectives_allowed:
                flag(node, f"naked collective {func.id}; take it through a launch.mesh Group")
            continue
        if not isinstance(func, ast.Attribute):
            continue
        chain = _chain(func)
        attr = chain[-1]
        if step_loop and attr in HOST_SYNC_ATTRS and not node.args:
            flag(node, f".{attr}() in the step loop makes the host wait for the card")
        elif step_loop and chain[:-1] == ["time"]:
            flag(node, f"time.{attr}() in the step loop: host time has no place in a run; "
                       "timing belongs outside core/ and kernels/")
        elif (attr in COLLECTIVE_NAMES and not collectives_allowed
              and any(a in DIST_ALIASES for a in chain[:-1])):
            flag(node, f"naked collective {'.'.join(chain)}; take it through a launch.mesh "
                       "Group so rule R2 sees the group")
    return found


def lint_module(path: Path, root: Path = None) -> list:
    root = root or package_root()
    rel = path.relative_to(root).as_posix()
    return lint_source(path.read_text(), rel,
                       step_loop=rel.split("/")[0] in STEP_LOOP_DIRS and rel not in HOST_SIDE,
                       collectives_allowed=rel == COLLECTIVES_MODULE)


def lint_all(root: Path = None) -> tuple:
    """Lint every module of the package (the audit package itself aside,
    whose corpus seeds violations on purpose); returns (findings, modules)."""
    root = root or package_root()
    findings, modules = [], []
    for path in sorted(root.rglob("*.py")):
        if path.relative_to(root).parts[0] == "audit":
            continue
        modules.append(path.relative_to(root).as_posix())
        findings.extend(lint_module(path, root))
    return findings, modules
