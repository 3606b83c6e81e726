"""The LM layout's specs, shardings and placement against the JAX package,
and the FSDP step on a one-rank layout in process (the CPU; gloo).

1. Specs, leaf for leaf, on JAX abstract meshes of 2 x 2, 16 x 16 and
   2 x 16 x 16 against the port's `ShapeGroup` layouts of the same shapes:
   every parameter of all ten configs under `param_spec`,
   `param_spec_serve` and `param_spec_dp` (the reference leaf's spec less
   its stacked entry, the port's leaf its row: where the reference cuts
   the stacked dim itself, as it does the MoE shared expert's (L, d, f)
   over model when model divides L, the port's row is whole on that axis),
   the train state's and the
   serving posture's trees (llama4-400b falls back to the training specs),
   `cache_spec` for yi-6b, zamba2-7b and deepseek-v2-lite-16b, the batch
   fallbacks, `use_dp_over_model` and `logits_shardings`; and the cases
   of tests/test_sharding.py (rank and divisibility, caches, serve
   stripping fsdp, batch fallbacks) on the port's specs.
2. Placement: on a 2 x 2 layout, every rank's block of every parameter of
   reduced qwen2-0.5b and deepseek-v2-lite-16b (`shard_leaf`) is the block
   that JAX's `NamedSharding(...).devices_indices_map` gives the device at
   the same mesh position (four forced host devices in a subprocess).
3. A one-rank gloo layout: `reshard` (the port of
   tests/test_runtime.py::test_elastic_reshard_roundtrip), and the FSDP
   step of reduced qwen2-0.5b, deepseek-v2-lite-16b and zamba2-7b in bf16,
   two steps, equal to the single-device step bit for bit (loss, grad
   norm, every gradient leaf, params, mu, nu, master); the tensor-parallel
   posture at model > 1 raises.
"""
import functools
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.launch import steps as JS
from repro.optim import adamw as jadamw
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import mesh, steps
from repro_torch.models import model as M
from repro_torch.models.config import TRAIN_4K
from repro_torch.optim import adamw
from repro_torch.runtime import failures
from repro_torch.sharding import rules

ARCHS = sorted(configs.ARCHS)
SHAPES = {"2x2": (2, 2), "16x16": (16, 16), "2x16x16": (2, 16, 16)}
CACHE_ARCHS = ["yi-6b", "zamba2-7b", "deepseek-v2-lite-16b"]


def jmesh(sizes):
    axes = ("pod", "data", "model") if len(sizes) == 3 else ("data", "model")
    return AbstractMesh(tuple(sizes), axes)


def norm(spec):
    """A spec (PartitionSpec or the port's tuple) as a tuple of axis tuples."""
    return tuple(rules.entry_axes(e) for e in spec)


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    flat = jax.tree_util.tree_flatten_with_path(JS.abstract_params(jconfigs.get(arch)))[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return steps.abstract_params(configs.get(arch))


def ref_of(arch, name):
    """The reference leaf of a port parameter and whether the port's is a row."""
    keys, stacked = rules.ref_leaf(name)
    leaf = ref_params(arch)[keys]
    return keys, leaf, stacked


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, shape):
    jm, layout = jmesh(SHAPES[shape]), mesh.shape_layout(SHAPES[shape])
    names = port_params(arch)
    rows = {}
    for name in names:
        keys, stacked = rules.ref_leaf(name)
        rows[keys] = rows.get(keys, 0) + 1
    assert rows == {k: v.shape[0] if any(rules.ref_leaf(n) == (k, True) for n in names) else 1
                    for k, v in ref_params(arch).items()}       # every row of every leaf
    for name, leaf in names.items():
        keys, ref, stacked = ref_of(arch, name)
        assert tuple(leaf.shape) == tuple(ref.shape)[stacked:], name
        for jfn, pfn in ((jrules.param_spec, rules.param_spec),
                         (jrules.param_spec_serve, rules.param_spec_serve),
                         (jrules.param_spec_dp, rules.param_spec_dp)):
            want = norm(jfn(jm, keys, ref))
            assert norm(pfn(layout, (name,), leaf)) == want[stacked:], (name, pfn.__name__)


def _check_rank_and_divisibility(layout, tree, spec_fn):
    for path, leaf in tree:
        spec = spec_fn(layout, path, leaf)
        assert len(spec) == len(leaf.shape), (path, spec, leaf.shape)
        for dim, part in zip(leaf.shape, spec):
            size = math.prod(layout.shape[a] for a in rules.entry_axes(part))
            assert dim % size == 0, (path, spec, leaf.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_rank_and_divisibility(arch):
    """tests/test_sharding.py's case on the port's specs (16 x 16)."""
    layout = mesh.make_production_mesh()
    tree = [((n,), v) for n, v in port_params(arch).items()]
    for spec_fn in (rules.param_spec, rules.param_spec_serve, rules.param_spec_dp):
        _check_rank_and_divisibility(layout, tree, spec_fn)


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_rank_and_divisibility(arch):
    layout = mesh.make_production_mesh()
    caches = steps.abstract_caches(configs.get(arch), batch=128, max_seq=32768)
    tree = [((g, i, k), v) for g, layers in caches.items() for i, c in enumerate(layers)
            for k, v in c.items()]
    _check_rank_and_divisibility(layout, tree, rules.cache_spec)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_match_reference(arch, shape):
    jm, layout = jmesh(SHAPES[shape]), mesh.shape_layout(SHAPES[shape])
    want = JS.abstract_caches(jconfigs.get(arch), 128, 32768)
    got = steps.abstract_caches(configs.get(arch), 128, 32768)
    specs = steps.cache_shardings(layout, configs.get(arch), 128, 32768)
    ref = JS.cache_shardings(jm, jconfigs.get(arch), 128, 32768)
    assert set(got) == set(want)
    for group, layers in got.items():
        for key, leaf in want[group].items():
            assert len(layers) == leaf.shape[0]
            spec = norm(jrules.cache_spec(jm, (group, key), leaf))
            assert norm(ref[group][key].spec) == spec
            for i, c in enumerate(layers):
                assert tuple(c[key].shape) == tuple(leaf.shape[1:])
                assert c[key].device.type == "meta"
                assert norm(specs[group][i][key]) == spec[1:], (group, i, key)


def test_serve_spec_strips_fsdp_only():
    layout = mesh.make_production_mesh(multi_pod=True)
    for name, leaf in port_params("yi-6b").items():
        train = rules.param_spec(layout, (name,), leaf)
        serve = rules.param_spec_serve(layout, (name,), leaf)
        for t, s in zip(train, serve):
            assert set(rules.entry_axes(s)) == set(rules.entry_axes(t)) - {"pod", "data"}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_batch_spec_fallbacks(shape):
    jm, layout = jmesh(SHAPES[shape]), mesh.shape_layout(SHAPES[shape])
    if shape == "2x16x16":      # tests/test_sharding.py's cases
        assert rules.batch_spec(layout, 256) == (("pod", "data"),)
        assert rules.batch_spec(layout, 48) == ("data",)
        assert rules.batch_spec(layout, 1) == (None,)
    for batch in (1, 2, 4, 6, 48, 128, 256, 512, 1024):
        for include_model in (False, True):
            assert norm(rules.batch_spec(layout, batch, include_model)) == norm(
                jrules.batch_spec(jm, batch, include_model)), (batch, include_model)
            shp = (batch, 4096, 32)
            assert norm(rules.data_spec(layout, shp, include_model)) == norm(
                jrules.data_spec(jm, shp, include_model))
    specs = {"inputs": steps.Spec((48, 16), torch.int32), "pos": steps.Spec((), torch.int32)}
    jspecs = {"inputs": jax.ShapeDtypeStruct((48, 16), np.int32),
              "pos": jax.ShapeDtypeStruct((), np.int32)}
    got, want = steps.batch_shardings(layout, specs), JS.batch_shardings(jm, jspecs)
    assert {k: norm(v) for k, v in got.items()} == {k: norm(v.spec) for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_choice_logits_and_shardings_match_reference(arch):
    """use_dp_over_model, logits_shardings, param_shardings (training and
    serving, with the serving fallback) and state_shardings (both
    postures), leaf for leaf."""
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    opt = adamw.OptConfig()
    for shape, sizes in SHAPES.items():
        jm, layout = jmesh(sizes), mesh.shape_layout(sizes)
        for batch in (1, 4, 48, 256):
            assert steps.use_dp_over_model(cfg, layout, batch) == JS.use_dp_over_model(
                jcfg, jm, batch), (shape, batch)
            assert norm(steps.logits_shardings(layout, cfg, batch)) == norm(
                JS.logits_shardings(jm, jcfg, batch).spec)
        if shape == "2x2":
            continue
        for serve in (False, True):
            got = steps.param_shardings(layout, cfg, serve=serve)
            want = {tuple(str(getattr(k, "key", k)) for k in p): s.spec for p, s in
                    jax.tree_util.tree_flatten_with_path(
                        JS.param_shardings(jm, jcfg, serve=serve))[0]}
            for name, spec in got.items():
                keys, stacked = rules.ref_leaf(name)
                assert norm(spec) == norm(want[keys])[stacked:], (shape, serve, name)
        for dp in (False, True):
            got = steps.state_shardings(layout, cfg, opt, dp)
            want = JS.state_shardings(jm, jcfg, jadamw.OptConfig(), dp)
            for part in ("mu", "nu", "master"):
                ref = {tuple(str(getattr(k, "key", k)) for k in p): s.spec for p, s in
                       jax.tree_util.tree_flatten_with_path(getattr(want.opt, part))[0]}
                for name, spec in getattr(got.opt, part).items():
                    keys, stacked = rules.ref_leaf(name)
                    assert norm(spec) == norm(ref[keys])[stacked:], (shape, dp, part, name)
                    assert spec == got.params[name]
            assert got.opt.count == () and got.step == ()
            assert norm(want.step.spec) == () and norm(want.opt.count.spec) == ()


def test_abstract_trees_and_spec_arithmetic():
    """The abstract trees are meta tensors; the bytes per rank of the train
    state equal the sum over leaves of their blocks' bytes, and qwen2-0.5b at
    TRAIN_4K takes the DP posture on 16 x 16 (256 sequences over 256 ranks,
    14 B a parameter over 16 fsdp ranks within 10 GB), not on 2 x 16 x 16
    (256 sequences do not divide 512 ranks)."""
    cfg, opt = configs.get("qwen2-0.5b"), adamw.OptConfig()
    st = steps.abstract_train_state(cfg, opt)
    leaves = list(st.params.values()) + [t for tree in st.opt[:3] for t in tree.values()]
    assert all(t.device.type == "meta" for t in leaves + [st.step, st.opt.count])
    n = sum(p.numel() for p in st.params.values())
    assert n == sum(int(np.prod(v.shape)) for v in ref_params("qwen2-0.5b").values())
    for sizes in ((16, 16), (2, 16, 16)):
        layout = mesh.shape_layout(sizes)
        assert steps.use_dp_over_model(cfg, layout, TRAIN_4K.global_batch) == (len(sizes) == 2)
        fsdp = math.prod(sizes[:-1])
        for dp in (False, True):
            got = steps.state_bytes_per_rank(layout, cfg, opt, dp)
            specs = steps.state_shardings(layout, cfg, opt, dp)
            want = 0
            for part, dtype_bytes in (("params", 2), ("mu", 4), ("nu", 4), ("master", 4)):
                tree = specs.params if part == "params" else getattr(specs.opt, part)
                for k, spec in tree.items():
                    cut = math.prod(layout.shape[a] for e in spec for a in rules.entry_axes(e))
                    want += st.params[k].numel() // cut * dtype_bytes
            assert got == want
            # Every leaf that the fsdp axes divide is cut over them; the rest
            # (norms, biases, small dims) is whole: under 14 B x n / fsdp x 1.01.
            assert n * 14 / fsdp <= got <= n * 14 / fsdp * 1.01 or not dp


def test_production_layouts():
    single, multi = mesh.make_production_mesh(), mesh.make_production_mesh(multi_pod=True,
                                                                           rank=300)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.coords == {"pod": (1, 2), "data": (2, 16), "model": (12, 16)}
    assert rules.fsdp_axes(multi) == ("pod", "data") and rules.fsdp_axes(single) == ("data",)
    assert multi.group(("pod", "data")).size == 32 and multi.group(("pod", "data")).rank == 18
    assert multi.group(("model", "data", "pod")).rank == 300
    with pytest.raises(RuntimeError, match="no collectives"):
        multi.world.gather(torch.zeros(1))
    with pytest.raises(KeyError):
        multi.group(("pod", "model"))


# ---------------------------------------------------------------------------
# Placement against JAX's devices_indices_map (four forced host devices)
# ---------------------------------------------------------------------------

PLACEMENT_ARCHS = ["qwen2-0.5b", "deepseek-v2-lite-16b"]
_PLACEMENT_SCRIPT = r'''
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import NamedSharding
from repro import configs
from repro.launch import steps
from repro.launch.mesh import make_host_mesh
from repro.sharding import rules
mesh = make_host_mesh(2, 2)
out = {}
for arch in sys.argv[1:]:
    flat = jax.tree_util.tree_flatten_with_path(steps.abstract_params(configs.get(arch).reduced()))[0]
    for fn in ("param_spec", "param_spec_dp"):
        for path, leaf in flat:
            keys = "/".join(str(getattr(k, "key", k)) for k in path)
            idx = NamedSharding(mesh, getattr(rules, fn)(mesh, path, leaf)).devices_indices_map(leaf.shape)
            out[f"{arch}|{fn}|{keys}"] = [
                [[s.start or 0, s.stop if s.stop is not None else n] for s, n in zip(idx[dev], leaf.shape)]
                for dev in mesh.devices.reshape(-1)]
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def jax_blocks():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    res = subprocess.run([sys.executable, "-c", _PLACEMENT_SCRIPT, *PLACEMENT_ARCHS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.parametrize("spec_fn", ["param_spec", "param_spec_dp"])
@pytest.mark.parametrize("arch", PLACEMENT_ARCHS)
def test_blocks_match_jax_devices_indices_map(jax_blocks, arch, spec_fn):
    """Rank r of the port's 2 x 2 layout sits at JAX's mesh position
    (r // 2, r % 2); its block of each parameter (the values of an arange,
    so a wrong block cannot pass) is JAX's block of the same leaf there."""
    cfg = configs.get(arch).reduced()
    fn = getattr(rules, spec_fn)
    checked = 0
    for name, leaf in steps.abstract_params(cfg).items():
        keys, stacked = rules.ref_leaf(name)
        blocks = jax_blocks[f"{arch}|{spec_fn}|{'/'.join(keys)}"]
        whole = np.arange(leaf.numel()).reshape(tuple(leaf.shape))
        for r in range(4):
            layout = mesh.shape_layout((2, 2), r)
            got = rules.shard_leaf(fn(layout, (name,), leaf), whole, layout.coords)
            want_idx = blocks[r][stacked:]
            assert not stacked or blocks[r][0] == [0, blocks[r][0][1]], (name, blocks[r])
            want = whole[tuple(slice(a, b) for a, b in want_idx)]
            np.testing.assert_array_equal(got, want, err_msg=f"{name} rank {r}")
            checked += got.size != whole.size
    assert checked > 0          # some leaves are cut


# ---------------------------------------------------------------------------
# A one-rank gloo layout in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path_factory.mktemp('rdv')}/f",
                            rank=0, world_size=1)
    try:
        yield mesh.make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_elastic_reshard_roundtrip(one_rank):
    """Host-restored state re-placed on a (new) 1 x 1 layout
    (tests/test_runtime.py's case); a TrainState-shaped tree of numpy
    leaves, bf16 included, comes back equal, each leaf a tensor of its own."""
    tree = {"w": np.ones((4, 4), np.float32)}
    out = failures.reshard(tree, one_rank, lambda path, leaf: (None, None))
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])
    cfg = configs.get("qwen2-0.5b").reduced()
    whole = steps.init_train_state(M.init_params(cfg, 0, "cpu"), adamw.OptConfig())
    host = {k: v.detach().clone() for k, v in whole.params.items()}
    placed = failures.reshard(host, one_rank,
                              lambda path, leaf: rules.param_spec_dp(one_rank, path, leaf))
    for k, v in placed.items():
        assert torch.equal(v.view(torch.int16), host[k].view(torch.int16))
        assert v.untyped_storage().data_ptr() != host[k].untyped_storage().data_ptr()
    back = rules.gather_tree_to_host(steps.state_shardings(one_rank, cfg, adamw.OptConfig(), True),
                                     steps.shard_state(one_rank, whole, True),
                                     group_of=one_rank.group, coords=one_rank.coords)
    for k, v in whole.opt.mu.items():
        assert torch.equal(back.opt.mu[k], v) and torch.equal(back.params[k], whole.params[k])


class GradTap:
    """Keeps the gradients each train step hands `adamw.update`."""

    def __enter__(self):
        self.grads, self._update = [], adamw.update

        def update(grads, *args, **kwargs):
            self.grads.append({k: v.detach().clone() for k, v in grads.items()})
            return self._update(grads, *args, **kwargs)
        adamw.update = update
        return self

    def __exit__(self, *exc):
        adamw.update = self._update


def bits(t):
    return t.detach().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b", "zamba2-7b"])
def test_one_rank_fsdp_step_equals_single_device_bitwise(one_rank, arch):
    cfg = configs.get(arch).reduced()
    opt = adamw.OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    data = DataConfig(seed=3)
    model = M.init_params(cfg, 0, "cpu")
    start = steps.clone_state(steps.init_train_state(model, opt))
    single = steps.make_train_step(cfg, opt, remat=True)
    layout = one_rank.counting()
    fsdp = steps.make_train_step(cfg, opt, remat=True, mesh=layout, dp_over_model=True)
    st, mst = steps.bind(model, steps.clone_state(start)), steps.shard_state(layout, start, True)
    skeleton = M.LMModel(cfg, None, "meta")
    for i in range(2):
        batch = make_batch(cfg, data, i, 4, 16, "cpu")
        with GradTap() as ts:
            st, ms = single(model, st, batch)
        with GradTap() as tm:
            mst, mm = fsdp(skeleton, mst, steps.shard_batch(layout, batch, True))
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(bits(ms[k]), bits(mm[k])), (i, k)
        for k, g in ts.grads[0].items():
            assert torch.equal(bits(g), bits(tm.grads[0][k])), (i, k)
    for part in ("mu", "nu", "master"):
        for k, v in getattr(st.opt, part).items():
            assert torch.equal(bits(v), bits(getattr(mst.opt, part)[k])), (part, k)
    for k, v in st.params.items():
        assert torch.equal(bits(v), bits(mst.params[k])), k
    gathers = layout.counts()["data"]["gather"]
    assert gathers["calls"] > 0 and gathers["bytes"] > 0


def test_tensor_parallel_posture_raises_at_model_above_one():
    """Both postures at model > 1 (the tensor-parallel one no longer raises):
    at 2 x 2 the default plans the two-cut posture, `rules.param_spec`'s
    blocks with the gradient never summed over model; the DP posture plans
    one fsdp cut and sums over model."""
    cfg, opt = configs.get("qwen2-0.5b").reduced(), adamw.OptConfig()
    tp_step = steps.make_train_step(cfg, opt, mesh=mesh.shape_layout((2, 2)))
    assert tp_step.tp and tp_step.blocks == 2
    wq = tp_step.plan["layers.0.attn.wq"]
    assert (wq.dim, wq.axes, wq.model_dim, wq.rest) == (0, ("data",), 1, ())
    assert all("model" not in lf.rest for lf in tp_step.plan.values())
    dp = steps.make_train_step(cfg, opt, mesh=mesh.shape_layout((2, 2)), dp_over_model=True)
    assert not dp.tp and dp.blocks == 4
    assert dp.plan["layers.0.attn.wq"].model_dim is None
    assert dp.plan["layers.0.attn.wq"].rest == ("model",)
    steps.make_train_step(cfg, opt, mesh=mesh.shape_layout((4, 1)))     # model == 1: both run
