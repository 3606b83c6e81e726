"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on meta
tensors, as one rank of the production layout runs it (port of
`repro/launch/dryrun.py`).

For each cell this:
  1. builds rank 0's blocks of the step's arguments as meta tensors (shapes
     and dtypes, no storage) by the port's specs: the train state in the
     posture `steps.use_dp_over_model` picks, or the served weights
     (`steps.shard_params`: tensor parallel, or the training specs where the
     weights whole over the fsdp axes exceed the budget) and their caches
     (`steps.make_cache`), and the batch (`steps.batch_shardings`),
  2. runs the port's own step on them, `make_train_step(mesh=)`,
     `make_prefill_step(cfg, mesh=)` or `make_decode_step(cfg, mesh=)`, on
     a layout of the production shape (16 x 16 single-pod, 2 x 16 x 16
     multi-pod) whose groups move shapes (`mesh.meta_layout`) and count
     every collective (`mesh.CountingGroup`),
  3. records the rank's bytes (arguments, outputs, the peak of the step's
     own storages), its FLOPs and the collective census,
  4. writes the row to the JSON results file (resumable: existing cells are
     skipped unless --force).

Nothing is computed on any device: meta tensors stand for the tensors, as
the reference's placeholder host devices stand for the chips.  This is not
a CPU fallback of the step; it needs no card and runs anywhere.

The row keeps the reference's keys.  `lower_s` is the trace's seconds.
`flops` is the rank's, by the rules of `torch.utils.flop_counter`'s
`FlopCounterMode`, which count matmul-like ops (matmuls, convolutions,
attention) only, where XLA's count has every op.  `mem_per_device`: `argument_size` the bytes of
the rank's arguments by the specs, `output_size` the bytes of the step's
outputs, `temp_size` the peak of the storages the step holds beyond its
arguments, its new outputs among them (`StepMeter`).  `collectives` maps the layout's counted
collectives onto the reference's HLO names in its convention of result
bytes; `count` is calls made where the reference counts HLO instructions.
The columns with no counterpart are null and listed in the row's
`no_counterpart`: there is no compile, no HLO, no generated code and no
scanned loop body.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
      PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --multi-pod
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.launch import mesh as _mesh
from repro_torch.launch import steps as S
from repro_torch.launch.distributed import held_bytes
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ALL_SHAPES, ModelConfig, ShapeConfig, shape_applicability
from repro_torch.optim import adamw
from repro_torch.sharding import rules

RESULTS = "dryrun_results_torch.json"
META = torch.device("meta")

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
# A counted collective -> the reference's HLO instruction.
HLO_NAME = {"gather": "all-gather", "merge": "all-reduce", "reduce": "all-reduce",
            "grad_sum": "all-reduce", "scatter_sum": "reduce-scatter",
            "all_to_all": "all-to-all"}
NO_COUNTERPART = ("compile_s", "hlo_bytes", "generated_code_size", "in_loop_bytes")


# ---------------------------------------------------------------------------
# The storages a step holds
# ---------------------------------------------------------------------------

class StepMeter(TorchDispatchMode):
    """The storages and FLOPs of the ops run under it.

    Storages: the bytes of those the ops create that are still alive, `live`
    now and `peak` the most at any time.  Each op's outputs are counted once
    per storage (a view, or an in-place op's result, shares a storage of
    its inputs and adds nothing), and a storage is taken off when it is
    freed (`weakref.finalize`), as autograd drops its saved tensors and
    remat its recomputed ones.  Storages made before it (the arguments) are
    not counted, nor those made while `paused` is above 0.

    FLOPs: `flops`, by `torch.utils.flop_counter`'s registry, the rules of
    `FlopCounterMode` (matmul-like ops only), and like it an op the
    registry lacks runs as its decomposition, so that a matmul under
    inference mode is counted as the mm it runs (and its temporaries as
    the storages they are).  FlopCounterMode itself is not used: it also
    tracks modules with hooks that keep tensors alive, which would move the
    peak."""

    def __init__(self):
        super().__init__()
        self.sizes: Dict[int, int] = {}
        self.live = self.peak = self.paused = self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        count = flop_registry.get(func._overloadpacket)
        if count is None:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not self.paused:
            self._count(out, args, kwargs)
        return out

    def _count(self, out, args, kwargs) -> None:
        inputs = None
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.sizes:
                continue
            if inputs is None:
                inputs = {a.untyped_storage()._cdata for a in tree_leaves((args, kwargs))
                          if isinstance(a, torch.Tensor)}
            if key in inputs:
                continue
            self.sizes[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key)


@contextlib.contextmanager
def _skeletons_uncounted(meter: StepMeter):
    """`meter` paused while a step builds a model skeleton (`M.LMModel` on
    the meta device: `steps.abstract_params`, the serving unit's plan):
    the real step makes those on meta too, so they cost the card nothing."""
    init = M.LMModel.__init__

    def paused_init(self, *args, **kwargs):
        meter.paused += 1
        try:
            init(self, *args, **kwargs)
        finally:
            meter.paused -= 1
    M.LMModel.__init__ = paused_init
    try:
        yield
    finally:
        M.LMModel.__init__ = init


# ---------------------------------------------------------------------------
# A cell's arguments and its trace
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _activations(dtype: Optional[torch.dtype]):
    """`layers.ACT_DTYPE` set to dtype (None: left as it is) while the block
    runs."""
    act = L.ACT_DTYPE
    L.ACT_DTYPE = dtype or act
    try:
        yield
    finally:
        L.ACT_DTYPE = act


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _skeleton(cfg: ModelConfig, dtype: Optional[torch.dtype]) -> M.LMModel:
    """A meta-device model of `cfg`, its parameters in dtype (None: their own)."""
    model = M.LMModel(cfg, None, META)
    return model if dtype is None else model.to(dtype)


def rank_arguments(cfg: ModelConfig, shape: ShapeConfig, layout, dp_over_model: bool = False,
                   opt_cfg: Optional[adamw.OptConfig] = None, *, cache_len: Optional[int] = None,
                   budget: float = 10e9, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The layout rank's blocks of a cell's step arguments as meta tensors,
    by the specs: `state` (train: params, mu, nu, master, count, step in
    the posture `dp_over_model` names) or `model` (the served weights,
    `steps.shard_params` under `budget`) and `caches` (`steps.make_cache`
    of `cache_len` positions, the cell's length when None); `batch` (the
    decode position a host int, the last one); and `bytes`, their sum,
    the position counted as the reference's int32 scalar.  dtype: the
    floating parameters' and activations' dtype (None: the model's own)."""
    opt_cfg = opt_cfg or adamw.OptConfig()
    specs = S.input_specs(cfg, shape)
    bspecs = S.batch_shardings(layout, specs, include_model=dp_over_model)
    batch = {k: shape.seq_len - 1 if k == "cache_pos" else
             _empty(rules.block_shape(bspecs[k], v.shape, layout), v.dtype)
             for k, v in specs.items()}
    nbytes = sum(v.dtype.itemsize * math.prod(rules.block_shape(bspecs[k], v.shape, layout))
                 for k, v in specs.items())
    out: Dict[str, Any] = {"batch": batch}
    with _activations(dtype):
        if shape.kind == "train":
            whole = S.abstract_train_state(cfg, opt_cfg)
            tspecs = S.state_shardings(layout, cfg, opt_cfg, dp_over_model)

            def blocks(tree, tree_specs):
                if tree is None:
                    return None
                return {k: _empty(rules.block_shape(tree_specs[k], v.shape, layout),
                                  dtype if tree is whole.params and dtype else v.dtype)
                        for k, v in tree.items()}
            o, os_ = whole.opt, tspecs.opt
            state = S.TrainState(
                params=blocks(whole.params, tspecs.params),
                opt=adamw.OptState(blocks(o.mu, os_.mu), blocks(o.nu, os_.nu),
                                   blocks(o.master, os_.master), _empty((), o.count.dtype)),
                step=_empty((), whole.step.dtype))
            out["state"] = state
            nbytes += held_bytes(state)["tensors"]
        else:
            out["model"] = S.shard_params(layout, cfg, _skeleton(cfg, dtype), budget)
            nbytes += held_bytes(dict(out["model"].named_parameters()))["tensors"]
            if not cfg.is_encoder:
                out["caches"] = S.make_cache(layout, cfg, shape.global_batch,
                                             cache_len or shape.seq_len)
                nbytes += held_bytes(out["caches"])["tensors"]
    out["bytes"] = nbytes
    return out


def collective_census(layout) -> Dict[str, Any]:
    """The counted collectives of a `CountingGroup` layout under the
    reference's HLO names: `count` calls made, `bytes` result bytes (a
    gather's output, an all-reduce's vector, a reduce-scatter's input /
    the group's size, an all-to-all's vector); no collective-permute is
    made; `total_bytes`; and `groups`, the census by group as
    `LMGroups.counts()` gives it."""
    out: Dict[str, Any] = {k: {"count": 0, "bytes": 0, "in_loop_bytes": None}
                           for k in COLLECTIVES}
    groups = layout.counts()
    for axes, counts in groups.items():
        size = layout.group(axes.split("+")).size
        for name, c in counts.items():
            if name in HLO_NAME:
                entry = out[HLO_NAME[name]]
                entry["count"] += c["calls"]
                entry["bytes"] += c["bytes"] // size if name == "scatter_sum" else c["bytes"]
    out["total_bytes"] = sum(out[k]["bytes"] for k in COLLECTIVES)
    out["groups"] = groups
    return out


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, sizes: Sequence[int],
               dp_over_model: Optional[bool] = None, rank: int = 0, *,
               opt_cfg: Optional[adamw.OptConfig] = None, cache_len: Optional[int] = None,
               budget: float = 10e9, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """One step of the cell (a train step with remat) on meta tensors as
    `rank` of a layout of `sizes` ((data, model) or (pod, data, model))
    runs it: the measured part of a
    row (`dp_over_model` for a train cell, `lower_s`, `flops`,
    `mem_per_device`, `collectives`).  dp_over_model: the train posture
    (None: `steps.use_dp_over_model`'s pick); cache_len, budget, dtype as
    `rank_arguments`."""
    opt_cfg = opt_cfg or adamw.OptConfig()
    layout = _mesh.meta_layout(sizes, rank)
    if shape.kind == "train" and dp_over_model is None:
        dp_over_model = S.use_dp_over_model(cfg, layout, shape.global_batch)
    dp = bool(dp_over_model) and shape.kind == "train"
    args = rank_arguments(cfg, shape, layout, dp, opt_cfg, cache_len=cache_len, budget=budget,
                          dtype=dtype)
    lay = layout.counting()
    meter = StepMeter()
    with _activations(dtype):
        t0 = time.perf_counter()
        if shape.kind == "train":
            skeleton = _skeleton(cfg, dtype)
            fn = S.make_train_step(cfg, opt_cfg, remat=True, mesh=lay, dp_over_model=dp)
            call = lambda: fn(skeleton, args["state"], args["batch"])
        elif shape.kind == "prefill":
            fn = S.make_prefill_step(cfg, lay)
            call = (lambda: fn(args["model"], args["batch"])) if cfg.is_encoder else \
                (lambda: fn(args["model"], args["caches"], args["batch"]))
        else:
            fn = S.make_decode_step(cfg, lay)
            call = lambda: fn(args["model"], args["caches"], args["batch"])
        with _skeletons_uncounted(meter), meter:
            out = call()
        lower_s = time.perf_counter() - t0
    row: Dict[str, Any] = {}
    if shape.kind == "train":
        row["dp_over_model"] = dp
    row.update(
        lower_s=round(lower_s, 1),
        compile_s=None,
        flops=float(meter.flops),
        hlo_bytes=None,
        mem_per_device={"argument_size": args["bytes"],
                        "output_size": held_bytes(out)["tensors"],
                        "temp_size": meter.peak, "generated_code_size": None},
        collectives=collective_census(lay),
        no_counterpart=list(NO_COUNTERPART))
    return row


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_cfg: Optional[adamw.OptConfig] = None) -> Dict[str, Any]:
    cfg = configs.get(arch)
    shape = next(s for s in ALL_SHAPES if s.name == shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    row: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "kind": shape.kind}
    skip = shape_applicability(cfg, shape)
    if skip:
        row.update(status="SKIP", reason=skip)
        return row
    measured = trace_cell(cfg, shape, (2, 16, 16) if multi_pod else (16, 16), opt_cfg=opt_cfg)
    row.update(status="OK", **measured)
    return row


def load_results(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def save_results(path: str, rows: Dict[str, Any]):
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)

    rows = load_results(args.out)
    archs = sorted(configs.ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in ALL_SHAPES] if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) else [args.multi_pod]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'2x16x16' if mp else '16x16'}"
                if key in rows and rows[key].get("status") in ("OK", "SKIP") \
                        and not args.force:
                    print(f"[cached] {key}")
                    continue
                print(f"[run] {key} ...", flush=True)
                try:
                    row = run_cell(arch, shape, mp)
                except Exception as e:
                    row = {"arch": arch, "shape": shape,
                           "mesh": '2x16x16' if mp else '16x16',
                           "status": "FAIL", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                rows[key] = row
                save_results(args.out, rows)
                extra = row.get("reason") or row.get("error") or \
                    f"trace={row.get('lower_s')}s flops={row.get('flops'):.3g}"
                print(f"  -> {row['status']}: {extra}", flush=True)


if __name__ == "__main__":
    main()
