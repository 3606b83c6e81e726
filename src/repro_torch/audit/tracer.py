"""Run an entry point on the CPU and record what it does (the port's
counterpart of tracing a closed jaxpr).

A `Trace` holds, for one run:

* every aten op under a `TorchDispatchMode`: its name, dtypes, shapes, the
  extents it reduces (for reductions), whether it accumulates, and the
  calling frames of the package (innermost last, "module.function");
* every collective made through a `TracingGroup` (a wrapper of a
  `launch.mesh` group): its kind, the name of the group it was made on,
  the elements it moves, its frames, and whether the connectivity update
  it belongs to had an excess to delete (`watch_updates`);
* every `torch.distributed` collective called from elsewhere than
  `launch/mesh.py` (a naked collective).

Entry points are registered in the `AUDIT` dicts beside their code
(`core/engine.py`, `core/ensemble.py`, `core/distributed.py`,
`serve/service.py`); `registry()` reads them, and each entry's builder
below runs it at N = 256 on the CPU.  The distributed entries run in one
spawned layout of two gloo ranks (`launch.distributed.run_ranks`), each
rank tracing itself; their findings are gathered to rank 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.audit import rules as _rules
from repro_torch.audit.astlint import COLLECTIVE_NAMES
from repro_torch.audit.report import Finding

PACKAGE = "repro_torch"
_SELF = __name__
REDUCTIONS = frozenset({"sum", "mean", "nansum", "var", "std", "var_mean", "std_mean", "prod",
                        "cumsum", "cumprod", "logsumexp", "norm", "linalg_vector_norm"})
ACCUMULATIONS = frozenset({"index_add", "index_add_", "scatter_add", "scatter_add_",
                           "scatter_reduce", "scatter_reduce_", "index_reduce", "index_reduce_",
                           "_index_put_impl_", "index_put", "index_put_", "put_", "put"})
# Accumulate only when asked to (their fourth argument).
ACCUMULATE_FLAG = frozenset({"index_put", "index_put_", "_index_put_impl_", "put", "put_"})


def frames(skip: int = 2) -> tuple:
    """The package's frames on the stack, outermost first, as
    "module.function" (the audit package's own machinery left out)."""
    out = []
    f = sys._getframe(skip)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith(PACKAGE) and mod != _SELF:
            out.append(f"{mod}.{f.f_code.co_name}")
        f = f.f_back
    return tuple(reversed(out))


@dataclasses.dataclass
class Op:
    name: str                 # "sum", "index_add_", ...
    dtypes: tuple
    shapes: tuple
    extents: tuple            # the sizes a reduction runs over
    accumulates: bool         # adds into an output at (possibly repeated) indices
    frames: tuple             # the calling module and function last

    @property
    def is_float(self) -> bool:
        return any(d is not None and d.is_floating_point for d in self.dtypes)


@dataclasses.dataclass
class Collective:
    kind: str                 # a `launch.mesh.Group` method: gather, merge, ...
    group: str                # the name of the group it was made on
    elements: int
    frames: tuple
    excess: Optional[bool]    # the enclosing update's predicate (None: no update)


class Trace:
    """What one run of an entry point did (module docs)."""

    def __init__(self):
        self.ops: List[Op] = []
        self.collectives: List[Collective] = []
        self.naked: List[tuple] = []
        self.excess: Optional[bool] = None
        self.paused = False
        self.sizes: tuple = ()

    def axes(self, engine, p: int = 1, k: int = 1) -> None:
        """Note the sharded and padded axis extents of a run of `engine`
        (on p ranks, k replicas): the neuron and edge axes, whole and cut,
        and the padded run width of every octree level (rule R4).  A run
        width equal to a coordinate, child or moment axis (3, 8, p^3) is
        left out: by its size alone the rule cannot tell the two apart."""
        widths = {int(layout.runs.shape[1]) for layout in engine.tree.levels}
        widths -= {3, 8, engine.fmm_cfg.p ** 3}
        self.sizes = tuple(sorted(set(sizes(engine.n, engine.edge_capacity, p, k)) | widths))

    def group(self, inner):
        """`inner` wrapped so that its collectives are recorded."""
        return None if inner is None else TracingGroup(inner, self)

    @contextlib.contextmanager
    def update(self, excess: bool):
        """Collectives inside belong to a connectivity update with (or
        without) an excess to delete."""
        prev, self.excess = self.excess, bool(excess)
        try:
            yield
        finally:
            self.excess = prev

    @contextlib.contextmanager
    def pause(self):
        prev, self.paused = self.paused, True
        try:
            yield
        finally:
            self.paused = prev

    def watch_updates(self, engine, whole_group=None) -> None:
        """Wrap `engine.connectivity_update` so its collectives carry the
        update's excess predicate, computed apart (paused) from the state it
        is given: some neuron holds more synapses than floor(elements).
        whole_group: the raw group a distributed engine merges degrees over."""
        from repro_torch.core import synapses
        inner = engine.connectivity_update

        def wrapped(state, noise, step, params=None, n_active=None):
            with self.pause():
                g = whole_group
                el = state.neurons
                ax, den = (torch.floor(t).to(torch.int32) for t in (el.ax_elems, el.den_elems))
                if g is not None:
                    ax, den = g.gather(ax), g.gather(den)
                n = ax.shape[0]
                deg = lambda ids: synapses._count(ids, state.edges.valid, n)
                d_src, d_dst = deg(state.edges.src), deg(state.edges.dst)
                if g is not None:
                    d_src, d_dst = g.merge(d_src), g.merge(d_dst)
                excess = bool(((d_src > ax).any() | (d_dst > den).any()))
            with self.update(excess):
                return inner(state, noise, step, params, n_active) if n_active is not None \
                    else inner(state, noise, step, params)
        engine.connectivity_update = wrapped


class TracingGroup:
    """A `launch.mesh` group that records each collective in a `Trace`."""

    def __init__(self, inner, trace: Trace):
        self.inner, self.trace = inner, trace
        self.rank, self.size, self.name = inner.rank, inner.size, inner.name
        self.device = inner.device

    def _record(self, kind: str, elements: int) -> None:
        if not self.trace.paused:
            self.trace.collectives.append(Collective(kind, self.name, int(elements),
                                                     frames(3), self.trace.excess))

    def gather(self, x):
        out = self.inner.gather(x)
        self._record("gather", out.numel())
        return out

    def merge(self, x):
        self._record("merge", x.numel())
        return self.inner.merge(x)

    def reduce(self, x):
        self._record("reduce", x.numel())
        return self.inner.reduce(x)

    def scatter_sum(self, x):
        self._record("scatter_sum", x.numel())
        return self.inner.scatter_sum(x)

    def all_to_all(self, x):
        self._record("all_to_all", x.numel())
        return self.inner.all_to_all(x)

    def gather_objects(self, obj):
        self._record("gather_objects", 0)
        return self.inner.gather_objects(obj)

    def gather_to_host(self, parts, dst=0):
        self._record("gather_to_host", sum(p.numel() for p in parts))
        return self.inner.gather_to_host(parts, dst)


def _extents(name: str, args, kwargs) -> tuple:
    """The sizes a reduction runs over: the reduced dims' sizes, or every
    dim's for a whole-tensor reduction."""
    x = args[0] if args and isinstance(args[0], torch.Tensor) else None
    if x is None:
        return ()
    dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
    if name in ("cumsum", "cumprod"):
        dims = [dims]
    if isinstance(dims, int):
        dims = [dims]
    if not isinstance(dims, (list, tuple)) or not dims or not all(isinstance(d, int)
                                                                  for d in dims):
        return tuple(x.shape) + (x.numel(),)
    return tuple(x.shape[d] for d in dims)


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.trace.paused:
            return out
        packet = func.overloadpacket.__name__
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if packet in ACCUMULATE_FLAG:
            acc = bool(kwargs.get("accumulate", args[3] if len(args) > 3 else False))
        else:
            acc = packet in ACCUMULATIONS
        self.trace.ops.append(Op(
            name=packet, dtypes=tuple(t.dtype for t in tensors),
            shapes=tuple(tuple(t.shape) for t in tensors),
            extents=_extents(packet, args, kwargs) if packet in REDUCTIONS else (),
            accumulates=acc, frames=frames(2)))
        return out


@contextlib.contextmanager
def _naked_collectives(trace: Trace):
    """Record every `torch.distributed` collective that no frame of
    `launch/mesh.py` makes."""
    import torch.distributed as dist
    saved = {}

    def wrap(name, fn):
        def call(*a, **k):
            fr = frames(2)
            if not trace.paused and not any(f.startswith("repro_torch.launch.mesh.")
                                            for f in fr):
                trace.naked.append((name,) + fr)
            return fn(*a, **k)
        return call
    for name in sorted(COLLECTIVE_NAMES):
        if hasattr(dist, name):
            saved[name] = getattr(dist, name)
            setattr(dist, name, wrap(name, saved[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def record(fn: Callable[[Trace], None]) -> Trace:
    """Run fn(trace) with its aten ops and collectives recorded."""
    trace = Trace()
    with _naked_collectives(trace), _Recorder(trace), torch.no_grad():
        fn(trace)
    return trace


@dataclasses.dataclass
class EntrySpec:
    """One auditable run: `run(trace)` drives it (wrapping its groups with
    `trace.group` and its engines with `trace.watch_updates`); `rules` maps
    a rule name to its configuration (`rules.RULES`)."""
    name: str
    run: Callable[[Trace], None]
    rules: Dict[str, dict]
    spawned: bool = False


def audit_trace(name: str, trace: Trace, rule_cfgs: Dict[str, dict]) -> List[Finding]:
    out = []
    for rule, cfg in rule_cfgs.items():
        if rule == "R4":
            cfg = dict(cfg, sizes=tuple(cfg.get("sizes", ())) + trace.sizes)
        out.extend(_rules.RULES[rule](name, trace, cfg))
    return out


def audit_entry(spec: EntrySpec) -> List[Finding]:
    """Run the entry in this process and apply its rules."""
    return audit_trace(spec.name, record(spec.run), spec.rules)


# -- the entry points of the port ------------------------------------------------

N, STEPS = 256, 110        # one connectivity update (update_interval 100)


def _configs(**engine):
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.msp import MSPConfig
    from repro_torch.core.traversal import FMMConfig
    return (MSPConfig.calibrated(speedup=400.0), FMMConfig(c1=8, c2=8, sigma=600.0),
            EngineConfig(**engine))


def _positions(n: int = N) -> np.ndarray:
    return np.random.default_rng(0).uniform(0, 1000.0, (n, 3)).astype(np.float32)


def _mid_growth(eng, state=None):
    """The engine's fresh (or given) state with calcium U(0.4, 0.7) and
    elements U(0, 6) (seeded): the first update forms synapses."""
    st = eng.init_state() if state is None else state
    g = np.random.default_rng(1)
    shape = st.neurons.calcium.shape
    t = lambda lo, hi: torch.as_tensor(g.uniform(lo, hi, shape).astype(np.float32))
    return st._replace(neurons=st.neurons._replace(calcium=t(0.4, 0.7), ax_elems=t(0, 6),
                                                   den_elems=t(0, 6)))


def _excess(eng, state):
    """A state whose edge table holds about 5 valid edges per neuron
    against floor(elements) = 1: the first update deletes on both sides
    (tests/test_probes.py's forced-deletion scenario)."""
    rng = np.random.default_rng(4)
    e = state.edges.valid.shape[-1]
    n = state.neurons.x.shape[-1]
    full = lambda v: torch.full(state.neurons.x.shape, v, dtype=torch.float32)
    edges = type(state.edges)(
        src=torch.as_tensor(rng.integers(0, n, e).astype(np.int32)),
        dst=torch.as_tensor(rng.integers(0, n, e).astype(np.int32)),
        valid=torch.as_tensor(rng.random(e) < 5 / eng.engine_cfg.edge_capacity_per_neuron))
    return state._replace(neurons=state.neurons._replace(ax_elems=full(1.7),
                                                         den_elems=full(1.7)), edges=edges)


def sizes(n: int, edges: int, p: int = 1, k: int = 1) -> tuple:
    """The extents of the sharded and padded axes of a run: the neuron and
    edge axes, whole and cut by p ranks, and K of them side by side."""
    return tuple(sorted({n, edges, n // p, edges // p, k * n, k * edges, k * n // p,
                         k * edges // p}))


def build_engine(method: str = "fmm", pyramid: str = "segsum"):
    from repro_torch.core.engine import PlasticityEngine

    def run(trace: Trace):
        msp_cfg, fmm_cfg, ecfg = _configs(method=method, pyramid=pyramid)
        eng = PlasticityEngine(_positions(), msp_cfg, fmm_cfg, ecfg, device="cpu")
        trace.axes(eng)
        eng.simulate(_mid_growth(eng), STEPS, seed=2)
    return run


def build_ensemble():
    from repro_torch.core.engine import PlasticityEngine
    from repro_torch.core.ensemble import EnsembleEngine, stack_states
    from repro_torch.launch import mesh, sweep

    def run(trace: Trace):
        msp_cfg, fmm_cfg, ecfg = _configs()
        eng = PlasticityEngine(_positions(), msp_cfg, fmm_cfg, ecfg, device="cpu")
        trace.axes(eng, k=2)
        ens = EnsembleEngine(eng, mesh=trace.group(mesh.ShapeGroup(1, name="ensemble")))
        grid = sweep.grid(sigma=[600.0, 750.0])
        ens.simulate(stack_states([_mid_growth(eng)] * 2), STEPS, seed=2,
                     params=sweep.pack_params(eng, grid))
    return run


def build_serve_round():
    import tempfile
    from repro_torch.launch import mesh
    from repro_torch.serve import SessionRequest, SimulationService

    def run(trace: Trace):
        msp_cfg, fmm_cfg, ecfg = _configs()
        with tempfile.TemporaryDirectory(prefix="audit_serve_") as tmp:
            svc = SimulationService(_positions(64), msp_cfg, fmm_cfg, ecfg, num_slots=2,
                                    round_steps=100, checkpoint_dir=tmp, device="cpu",
                                    mesh=trace.group(mesh.ShapeGroup(1, name="ensemble")))
            trace.axes(svc.engine, k=2)
            for i, n in enumerate((64, 40)):
                svc.submit(SessionRequest(session_id=f"s{i}", n_neurons=n, num_steps=200,
                                          seed=i))
            svc.run_round()
            svc.close()
    return run


def build_distributed(groups, deletion: bool = False, **options):
    """distributed.simulate on this rank of `groups` (a spawned layout)."""
    from repro_torch.core.distributed import DistributedPlasticityEngine
    from repro_torch.core.engine import EngineConfig, PlasticityEngine
    method = options.pop("method", "fmm")

    def run(trace: Trace):
        msp_cfg, fmm_cfg, _ = _configs()
        ecfg = EngineConfig(method=method, edge_capacity_per_neuron=8 if deletion else 64)
        eng = DistributedPlasticityEngine(_positions(), trace.group(groups.data), msp_cfg,
                                          fmm_cfg, ecfg, device="cpu", **options)
        trace.axes(eng, groups.data.size)
        trace.watch_updates(eng, groups.data)
        whole = PlasticityEngine.init_state(eng)
        whole = _excess(eng, whole) if deletion else _mid_growth(eng, whole)
        eng.simulate(eng.shard_state(whole), 2 * STEPS if deletion else STEPS, seed=2)
    return run


def build_distributed_ensemble(groups):
    from repro_torch.core.distributed import (DistributedEnsembleEngine,
                                              DistributedPlasticityEngine)
    from repro_torch.core.probes import ProbeSet, SpikeRasterProbe, TurnoverProbe
    from repro_torch.launch import sweep

    def run(trace: Trace):
        msp_cfg, fmm_cfg, ecfg = _configs()
        eng = DistributedPlasticityEngine(_positions(), trace.group(groups.data), msp_cfg,
                                          fmm_cfg, ecfg, device="cpu")
        trace.axes(eng, groups.data.size, k=2)
        trace.watch_updates(eng, groups.data)
        ens = DistributedEnsembleEngine(eng, trace.group(groups.ensemble))
        pset = ProbeSet([SpikeRasterProbe(), TurnoverProbe(np.arange(N) % 2, 2)],
                        chunk_size=STEPS)
        st = ens.init_states(2)
        st = st._replace(neurons=_mid_growth(eng, st).neurons)
        ens.simulate(st, STEPS, seed=2, params=sweep.pack_params(eng, sweep.grid(
            sigma=[600.0, 750.0])), probes=pset)
    return run


def _audit_dicts() -> dict:
    from repro_torch.core import distributed, engine, ensemble
    from repro_torch.serve import service
    out = {}
    for mod in (engine, ensemble, service, distributed):
        out.update(mod.AUDIT["entry_points"])
    return out


def _edge_table(deletion: bool = False) -> int:
    """The whole edge table's slots in an entry's run (R3's min_size)."""
    return N * (8 if deletion else 64)


def _resolve(rule_cfgs: dict, deletion: bool = False) -> dict:
    """The rules' configs with R3's min_size filled in."""
    return {rule: dict(cfg, min_size=_edge_table(deletion)) if rule == "R3" else cfg
            for rule, cfg in rule_cfgs.items()}


def registry(local_only: bool = False) -> List[EntrySpec]:
    """Every registered entry point with its builder.  The distributed
    entries are marked `spawned`: `audit_entries` runs them in a layout of
    two gloo ranks."""
    dicts = _audit_dicts()
    specs = []
    for combo in dicts["engine.simulate"]["combos"]:
        specs.append(EntrySpec(f"engine.simulate[{combo}]", build_engine(**combo),
                               _resolve(dicts["engine.simulate"]["rules"])))
    specs.append(EntrySpec("ensemble.simulate", build_ensemble(),
                           _resolve(dicts["ensemble.simulate"]["rules"])))
    specs.append(EntrySpec("serve.round", build_serve_round(),
                           _resolve(dicts["serve.round"]["rules"])))
    if local_only:
        return specs
    for name in ("distributed.simulate", "distributed.forced_deletion",
                 "distributed_ensemble.simulate"):
        for combo in dicts[name].get("combos", ({},)):
            specs.append(EntrySpec(f"{name}[{combo}]" if combo else name, None,
                                   dicts[name]["rules"], spawned=True))
    return specs


@dataclasses.dataclass
class SpawnedAudit:
    """The distributed entries, run on each rank of a spawned layout
    (`launch.distributed.run_ranks(2, [SpawnedAudit()], ensemble=1)`)."""

    def run(self, groups, device) -> dict:
        dicts = _audit_dicts()
        found, names = [], []
        for name in ("distributed.simulate", "distributed.forced_deletion",
                     "distributed_ensemble.simulate"):
            entry = dicts[name]
            deletion = name == "distributed.forced_deletion"
            for combo in entry.get("combos", ({},)):
                combo = dict(combo)
                rule_cfgs = dict(entry["rules"])
                if combo.get("find_phase") == "replicated":
                    rule_cfgs.pop("R3", None)   # gathers the edge table by design
                label = f"{name}[{combo}]" if combo else name
                run = (build_distributed_ensemble(groups)
                       if name == "distributed_ensemble.simulate"
                       else build_distributed(groups, deletion, **combo))
                trace = record(run)
                found.extend(audit_trace(label, trace, _resolve(rule_cfgs, deletion)))
                if deletion and not any(c.excess for c in trace.collectives):
                    found.append(Finding("R3", label, "the forced deletion ran no update "
                                         "with excess: R3 saw nothing"))
                if deletion:
                    # The sharded deletion ranks in place over the slot
                    # ranges: the table never leaves its ranks, excess or not.
                    found.extend(Finding("R3", label, f"a {c.elements}-element gather in "
                                         "the sharded deletion: the edge table left its ranks",
                                         " > ".join(c.frames[-3:]))
                                 for c in trace.collectives
                                 if c.kind == "gather" and c.elements >= _edge_table(deletion))
                names.append(label)
        every = groups.data.gather_objects(found)
        return dict(findings=[f for part in every for f in part], entries=names)


def audit_entries(specs: Optional[List[EntrySpec]] = None) -> tuple:
    """Audit every entry (default: the registry): the local ones in this
    process, the spawned ones in two gloo ranks.  Returns (findings, names)."""
    specs = registry() if specs is None else specs
    findings, names = [], []
    for spec in specs:
        if not spec.spawned:
            findings.extend(audit_entry(spec))
            names.append(spec.name)
    if any(s.spawned for s in specs):
        from repro_torch.launch.distributed import run_ranks
        res, = run_ranks(2, [SpawnedAudit()], "cpu", 300.0, 60.0, ensemble=1)
        findings.extend(res["findings"])
        names.extend(res["entries"])
    return findings, names
