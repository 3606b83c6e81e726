"""The dry run (`repro_torch.launch.dryrun`) against the JAX package's, on
the CPU, without importing `repro.launch.dryrun` (it sets XLA_FLAGS to 512
host devices at import): the reference's side is built from
`repro.models.config`, `repro.launch.steps` and `repro.sharding.rules` on
`AbstractMesh`es.

1. The rows: `main(--all)` writes the reference's 80 keys, and every SKIP
   row is the reference's (`shape_applicability`); the posture of every
   train cell is the reference's `use_dp_over_model`.
2. `argument_size` of all 80 cells, by the specs with no trace, against the
   sum of the reference's `NamedSharding(AbstractMesh, spec).shard_shape`
   bytes of the same arguments (state, or params and caches, and the
   batch), with the shared-expert deviation (ROADMAP Queue 3: the port
   keeps a MoE layer's shared expert whole over model, where the reference
   cuts its layer stack over model) reckoned leaf by leaf.
3. `MetaGroup`: each collective's result shape and dtype, its refusal of a
   tensor that is not on meta; every rank of a 2 x 2 `meta_layout` makes
   the same collectives with the same bytes.
4. `StepMeter` on a known sequence of ops (views, in-place ops, freed
   temporaries, autograd's saved tensors, remat's recomputation, inference
   mode), and the meta peak and FLOPs of reduced single-device steps
   against the same steps on real CPU tensors.
5. `main()` on a cheap real cell and a SKIP cell into a temporary --out; a
   second call prints `[cached]`.
"""
import dataclasses
import functools
import json
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.launch import steps as JS
from repro.models import config as jconfig
from repro.optim import adamw as jadamw
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh, steps
from repro_torch.launch.distributed import held_bytes
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ALL_SHAPES, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.sharding import rules

ARCHS = sorted(configs.ARCHS)
MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16)}
CELLS = [(a, s.name, m) for a in ARCHS for s in ALL_SHAPES for m in MESHES]


def jmesh(sizes):
    axes = ("pod", "data", "model") if len(sizes) == 3 else ("data", "model")
    return AbstractMesh(tuple(sizes), axes)


def shape_of(name):
    return next(s for s in ALL_SHAPES if s.name == name)


def jshape_of(name):
    return next(s for s in jconfig.ALL_SHAPES if s.name == name)


# ---------------------------------------------------------------------------
# 1. The rows
# ---------------------------------------------------------------------------

def ref_skip(arch, shape):
    return jconfig.shape_applicability(jconfigs.get(arch), jshape_of(shape))


def test_all_writes_the_reference_keys_and_skip_rows(tmp_path, capsys):
    """Every cell the reference traces is cached in the file beforehand (a
    placeholder OK row), so `--all` runs only the SKIP cells."""
    out = tmp_path / "rows.json"
    cached = {f"{a}|{s}|{m}": {"status": "OK"} for a, s, m in CELLS if not ref_skip(a, s)}
    out.write_text(json.dumps(cached))
    D.main(["--all", "--out", str(out)])
    rows = json.loads(out.read_text())
    assert set(rows) == {f"{a}|{s}|{m}" for a, s, m in CELLS} and len(rows) == 80
    skips = 0
    for a, s, m in CELLS:
        reason = ref_skip(a, s)
        if reason:
            skips += 1
            assert rows[f"{a}|{s}|{m}"] == {"arch": a, "shape": s, "mesh": m,
                                             "kind": shape_of(s).kind, "status": "SKIP",
                                             "reason": reason}
    assert skips == 18
    printed = capsys.readouterr().out
    assert printed.count("[cached]") == 80 - skips and printed.count("[run]") == skips


@pytest.mark.parametrize("sizes", list(MESHES.values()), ids=list(MESHES))
def test_train_posture_is_the_reference_choice(sizes):
    train = shape_of("train_4k")
    for arch in ARCHS:
        want = JS.use_dp_over_model(jconfigs.get(arch), jmesh(sizes), train.global_batch)
        got = steps.use_dp_over_model(configs.get(arch), mesh.meta_layout(sizes),
                                      train.global_batch)
        assert got == want, arch


# ---------------------------------------------------------------------------
# 2. argument_size against the reference's shardings
# ---------------------------------------------------------------------------

def _shard_bytes(tree, shardings) -> int:
    return sum(math.prod(sh.shard_shape(leaf.shape)) * leaf.dtype.itemsize
               for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(shardings)))


def _by_keys(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): v for path, v in flat}


@functools.lru_cache(maxsize=None)
def reference_arguments(arch, shape_name, sizes):
    """(bytes of the reference's arguments, the train posture, the
    reference's param shardings by key path) of a cell on an AbstractMesh."""
    cfg, shape, jm = jconfigs.get(arch), jshape_of(shape_name), jmesh(sizes)
    specs = JS.input_specs(cfg, shape)
    batch_sh = JS.batch_shardings(jm, specs)
    if shape.kind == "train":
        opt = jadamw.OptConfig()
        dp = JS.use_dp_over_model(cfg, jm, shape.global_batch)
        if dp:
            batch_sh = {k: NamedSharding(jm, jrules.data_spec(jm, v.shape, include_model=True))
                        for k, v in specs.items()}
        state_sh = JS.state_shardings(jm, cfg, opt, dp_over_model=dp)
        total = _shard_bytes(JS.abstract_train_state(cfg, opt), state_sh)
        params_sh = state_sh.params
    else:
        dp = False
        params_sh = JS.param_shardings(jm, cfg, serve=True)
        total = _shard_bytes(JS.abstract_params(cfg), params_sh)
        if not cfg.is_encoder:
            total += _shard_bytes(JS.abstract_caches(cfg, shape.global_batch, shape.seq_len),
                                  JS.cache_shardings(jm, cfg, shape.global_batch, shape.seq_len))
    total += _shard_bytes(specs, batch_sh)
    return total, dp, _by_keys(params_sh)


def deviation(arch, shape_name, sizes, dp) -> tuple:
    """Bytes the port's parameter blocks (and their mu, nu, master) hold
    beyond the reference's, leaf by leaf, and the leaves that differ.  A
    port leaf is a row of the reference's stacked leaf; where the reference
    cuts the stack itself over some axes, the port's rows are whole there,
    and the rank holds their product times the reference's shard."""
    cfg, shape = configs.get(arch), shape_of(shape_name)
    layout = mesh.meta_layout(sizes)
    _, _, ref_sh = reference_arguments(arch, shape_name, sizes)
    ref_leaves = _by_keys(JS.abstract_params(jconfigs.get(arch)))
    if shape.kind == "train":
        pspecs = steps.state_shardings(layout, cfg, adamw.OptConfig(), dp).params
        per_elem = lambda p: p.element_size() + 3 * 4      # + float32 mu, nu, master
    else:
        pspecs = steps.param_shardings(layout, cfg, serve=True)
        per_elem = lambda p: p.element_size()
    port, size = {}, {}
    for name, p in steps.abstract_params(cfg).items():
        keys, stacked = rules.ref_leaf(name)
        port[keys] = port.get(keys, 0) + math.prod(rules.block_shape(pspecs[name], p.shape,
                                                                     layout))
        size[keys] = per_elem(p)
    extra, differ = 0, []
    for keys, sh in ref_sh.items():
        leaf = ref_leaves[keys]
        ref = math.prod(sh.shard_shape(leaf.shape))
        if port[keys] == ref:
            continue
        stack_cut = math.prod(layout.shape[a] for a in rules.entry_axes(sh.spec[0]))
        assert port[keys] == ref * stack_cut and "shared" in keys, (keys, port[keys], ref)
        extra += (port[keys] - ref) * size[keys]
        differ.append(keys)
    return extra, differ


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "|".join(c))
def test_argument_size_is_the_reference_specs_bytes(cell):
    arch, shape_name, mesh_name = cell
    sizes = MESHES[mesh_name]
    want, dp, _ = reference_arguments(arch, shape_name, sizes)
    got = D.rank_arguments(configs.get(arch), shape_of(shape_name), mesh.meta_layout(sizes),
                           dp)["bytes"]
    extra, differ = deviation(arch, shape_name, sizes, dp)
    assert got == want + extra, (got, want, extra, differ)
    # the deviation is the shared experts of the MoE configs, where model
    # divides the layer stack in the posture's specs
    if differ:
        assert configs.get(arch).num_shared_experts and not dp, differ


def test_argument_size_deviation_is_where_the_roadmap_says():
    """The reference cuts the stack of a MoE layer's shared expert over
    model only where model divides the MoE layers (deepseek-v2-lite-16b's
    26, llama4's 24): at 16 x 16 neither config differs; at model 2 (a 1 x
    2 layout) both do, by half of the shared expert."""
    for arch in ("deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"):
        assert deviation(arch, "decode_32k", (16, 16), False)[1] == []
        extra, differ = deviation(arch, "decode_32k", (1, 2), False)
        cfg = configs.get(arch)
        n_moe = (cfg.num_layers - cfg.first_dense_layers) // cfg.moe_layer_step
        shared = n_moe * 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_shared_experts * 2
        assert differ and extra == shared // 2, (arch, extra, shared)


# ---------------------------------------------------------------------------
# 3. MetaGroup and the meta layout
# ---------------------------------------------------------------------------

def test_meta_group_moves_shapes():
    g = mesh.MetaGroup(4, 1, "model")
    x = torch.empty((3, 5), dtype=torch.bfloat16, device="meta")
    assert (g.gather(x).shape, g.gather(x).dtype) == ((12, 5), torch.bfloat16)
    assert (g.merge(x).shape, g.merge(x).dtype) == ((3, 5), torch.bfloat16)
    for fn in (g.reduce, g.grad_sum):
        assert (fn(x).shape, fn(x).dtype) == ((3, 5), torch.float32)
    assert g.scatter_sum(torch.empty((4, 3, 5), device="meta")).shape == (3, 5)
    assert g.all_to_all(x).shape == (3, 5)
    for fn in (g.gather, g.merge, g.reduce, g.grad_sum, g.scatter_sum, g.all_to_all):
        out = fn(x if fn != g.scatter_sum else torch.empty((4, 3), device="meta"))
        assert out.device.type == "meta" and out is not x
        with pytest.raises(ValueError, match="meta"):
            fn(torch.zeros((4, 3)))
    with pytest.raises(RuntimeError):
        g.gather_objects(1)
    with pytest.raises(RuntimeError):
        g.gather_to_host([x])
    lay = mesh.meta_layout((2, 16, 16), 37)
    shapes = mesh.shape_layout((2, 16, 16), 37)
    assert lay.device.type == "meta" and lay.coords == shapes.coords
    assert {k: (g.size, g.rank, g.name) for k, g in lay.groups.items()} == \
        {k: (g.size, g.rank, g.name) for k, g in shapes.groups.items()}
    with pytest.raises(RuntimeError, match="no collectives"):   # ShapeGroup still refuses
        shapes.groups[("model",)].gather(x)


REDUCED = ["qwen2-0.5b", "deepseek-v2-lite-16b", "zamba2-7b"]
STEPS = [("train", True), ("train", False), ("prefill", False), ("decode", False)]


def reduced(arch):
    cfg = configs.get(arch).reduced()
    return dataclasses.replace(cfg, capacity_factor=8.0) if cfg.num_experts else cfg


@pytest.mark.parametrize("kind,dp", STEPS, ids=["train-dp", "train-tp", "prefill", "decode"])
@pytest.mark.parametrize("arch", REDUCED)
def test_every_rank_makes_the_same_collectives(arch, kind, dp):
    cfg = reduced(arch)
    rows = [D.trace_cell(cfg, ShapeConfig("t", 16, 4, kind), (2, 2), dp, rank)
            for rank in range(4)]
    for r, row in enumerate(rows[1:], 1):
        assert row["collectives"] == rows[0]["collectives"], (arch, kind, r)
    assert rows[0]["collectives"]["total_bytes"] > 0


# ---------------------------------------------------------------------------
# 4. The live-storage tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_step_meter_on_a_known_sequence(device):
    f32 = lambda *s: torch.empty(s, device=device)
    live = D.StepMeter()
    with live:
        a = f32(1000)                                   # 4000
        b = a.view(10, 100)                             # a view: nothing
        b.mul_(2)                                       # in place: nothing
        c = a * 2                                       # 4000
        assert (live.live, live.peak) == (8000, 8000)
        del a, b
        assert live.live == 4000                        # a's storage freed with its view
        del c
        assert live.live == 0
        x = f32(100).requires_grad_()                   # 400
        y = x.exp()                                     # 400, saved by exp's backward
        live.peak = live.live
        z = (y * 3).sum()                               # 400 freed at once, 4 kept
        assert live.live == 804 and live.peak == 1204
        g, = torch.autograd.grad(z, x)                  # 400; y's saved result dropped after
        del y
        assert live.live == 804                         # x, g, z
        del z
        w = checkpoint(lambda t: (t.exp() * 2).exp(), x, use_reentrant=False)
        assert live.live == 1200                        # x, g, w: nothing saved between
        s = w.sum()
        peak = live.peak
        torch.autograd.grad(s, x)                       # the recomputation's temporaries
        assert live.peak > peak
        del w, s
        assert live.live == 800
        with torch.inference_mode():
            h = f32(50) + 1                             # the empty freed, 200 kept
            assert live.live == 1000
            flops = live.flops
            m = f32(2, 4, 8) @ f32(8, 16)               # matmul runs as its mm: 2 x 8 x 8 x 16
            assert live.flops - flops == 2 * 8 * 8 * 16 and live.live == 1000 + 2 * 4 * 16 * 4
        del h, m
    assert live.live == 800                             # x and g


def _single_device_step(kind, cfg, device):
    """A reduced single-device step of `kind` on `device` (meta: shapes
    only), in float32: the function to run and its arguments."""
    L.ACT_DTYPE = torch.float32
    opt = adamw.OptConfig()
    model = (M.init_params(cfg, 0, device) if device == "cpu"
             else M.LMModel(cfg, None, "meta")).float()
    toks = torch.zeros((2, 16), dtype=torch.int32, device=device)
    if kind == "train":
        state = steps.init_train_state(model, opt)
        batch = {"inputs": toks, "labels": toks}
        return lambda: steps.make_train_step(cfg, opt)(model, state, batch)
    caches = M.make_cache(cfg, 2, 16, device)
    if kind == "prefill":
        return lambda: steps.make_prefill_step(cfg)(model, caches, {"inputs": toks})
    return lambda: steps.make_decode_step(cfg)(model, caches, {"token": toks[:, :1],
                                                               "cache_pos": 15})


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", REDUCED)
def test_meta_peak_and_flops_equal_a_real_cpu_step(arch, kind):
    """The meta step under the dry run's `StepMeter`; the CPU step twice,
    under a `StepMeter` and under `FlopCounterMode`."""
    cfg, act = reduced(arch), L.ACT_DTYPE
    try:
        meter = D.StepMeter()
        step = _single_device_step(kind, cfg, "meta")
        with meter:
            out = step()
        meta = (meter.peak, meter.flops, held_bytes(out)["tensors"])
        del out
        live, counter = D.StepMeter(), FlopCounterMode(display=False)
        step = _single_device_step(kind, cfg, "cpu")
        with live:
            out = step()
        step = _single_device_step(kind, cfg, "cpu")
        with counter:
            step()
        cpu = (live.peak, counter.get_total_flops(), held_bytes(out)["tensors"])
    finally:
        L.ACT_DTYPE = act
    assert meta == cpu and meta[0] > 0 and meta[1] > 0, (meta, cpu)


# ---------------------------------------------------------------------------
# 5. main()
# ---------------------------------------------------------------------------

def test_main_runs_a_cell_and_a_skip_then_caches(tmp_path, capsys):
    out = str(tmp_path / "rows.json")
    D.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k", "--out", out])
    D.main(["--arch", "hubert-xlarge", "--shape", "decode_32k", "--out", out])
    first = capsys.readouterr().out
    rows = json.loads(open(out).read())
    row = rows["mamba2-1.3b|decode_32k|16x16"]
    assert row["status"] == "OK" and "[run] mamba2-1.3b|decode_32k|16x16" in first
    ref_ok_keys = {"arch", "shape", "mesh", "kind", "status", "lower_s", "compile_s", "flops",
                   "hlo_bytes", "mem_per_device", "collectives"}
    assert ref_ok_keys <= set(row) and row["no_counterpart"] == list(D.NO_COUNTERPART)
    assert row["compile_s"] is None and row["hlo_bytes"] is None and row["flops"] > 0
    mem = row["mem_per_device"]
    assert set(mem) == {"argument_size", "output_size", "temp_size", "generated_code_size"}
    assert mem["generated_code_size"] is None and min(mem["argument_size"], mem["temp_size"],
                                                      mem["output_size"]) > 0
    cc = row["collectives"]
    assert set(cc) == set(D.COLLECTIVES) | {"total_bytes", "groups"}
    assert cc["collective-permute"] == {"count": 0, "bytes": 0, "in_loop_bytes": None}
    assert cc["total_bytes"] == sum(cc[k]["bytes"] for k in D.COLLECTIVES) > 0
    assert cc["all-gather"]["count"] == sum(g["gather"]["calls"] for g in cc["groups"].values())
    assert rows["hubert-xlarge|decode_32k|16x16"]["status"] == "SKIP"
    D.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k", "--out", out])
    assert capsys.readouterr().out.strip() == "[cached] mamba2-1.3b|decode_32k|16x16"
