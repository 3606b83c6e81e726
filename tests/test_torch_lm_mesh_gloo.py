"""The FSDP train step over gloo in spawned CPU processes
(`run_ranks(..., lm=(data, model))`): a 2 x 2 layout (the DP-over-model
posture: the batch over all four ranks, weights cut over data) and a
2 x 1 one, each in one `run_ranks` call.

1. Reduced qwen2-0.5b (dense, qkv bias, tied), deepseek-v2-lite-16b (MLA,
   MoE, a dense prefix) and zamba2-7b (the Mamba2/attention hybrid), two
   steps each in float32 with remat, against the single-device port's
   step on the same global batches: the loss, the grad norm, every
   gradient leaf (gathered from the ranks' blocks before the update) and
   every leaf of params, mu, nu and master after each run, within 1e-5 of
   each leaf's largest magnitude (sums over ranks round another way).
2. The hollow-step checks: each rank's held bytes of params, mu, nu and
   master equal the spec arithmetic (and no block is a view into a larger
   storage); the census of one step is one gather a unit in the forward
   and one a unit in remat's recomputation, with the bytes the specs give
   those units, and no gather larger than the largest unit; every group's
   census equals the dry run's trace of the step on meta tensors
   (`launch.dryrun.trace_cell`), call for call and byte for byte.
3. `reshard` of a host tree (bf16 state) onto 2 x 2, then
   `sharding.rules.gather_tree_to_host`, gives back the same bits, and the
   blocks' bytes are `steps.state_bytes_per_rank`'s.
4. The elastic restart: qwen2 trained two steps at 2 x 2, its whole state
   saved from rank 0's host, restored and resharded onto
   `plan_elastic_mesh(2, 1)`'s layout, one more step, against three
   single-device steps at the same bound.
5. The reference's own sharded step: qwen2's two 2 x 2 steps against the
   JAX package's `make_train_step(mesh=make_host_mesh(2, 2),
   dp_over_model=True)`, jitted with `state_shardings` and the DP batch
   shardings over four forced host devices in a subprocess, in float32
   from the same state and batch (the fresh state, then the layout's own
   after its first step): loss, grad norm, every gradient leaf, mu and
   nu within 1e-5 of each leaf's largest magnitude, params and master as
   in 1.

Each call has a 120 s wall-clock limit and a 60 s collective timeout.
"""
import concurrent.futures
import dataclasses
import math
import os
import pickle
import subprocess
import sys
from typing import Optional

import numpy as np
import pytest
import torch

from _torch_lm_tp import meta_census
from repro_torch import configs, convert
from repro_torch.checkpoint.manager import restore_pytree, save_pytree
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import mesh, steps
from repro_torch.launch.distributed import held_bytes, run_ranks
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import failures
from repro_torch.sharding import rules

ARCHS = ["qwen2-0.5b", "deepseek-v2-lite-16b", "zamba2-7b"]
LAYOUTS = {"2x2": (2, 2), "2x1": (2, 1)}
B, S, STEPS, TOL, RESOLVED = 4, 16, 2, 1e-5, 1e-3
OPT_ARGS = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
OPT = adamw.OptConfig(**OPT_ARGS)
DATA = DataConfig(seed=5)


def reduced(arch):
    """A reduced config; MoE at capacity 8, where no assignment overflows."""
    cfg = configs.get(arch).reduced()
    return dataclasses.replace(cfg, capacity_factor=8.0) if cfg.num_experts else cfg


def float32_state(cfg):
    """The seeded model in float32 (activations too: L.ACT_DTYPE) and its
    fresh train state."""
    L.ACT_DTYPE = torch.float32
    model = M.init_params(cfg, 0, "cpu").float()
    return model, steps.init_train_state(model, OPT)


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


def numpy_state(state):
    return {part: {k: v.detach().numpy().copy() for k, v in tree.items()}
            for part, tree in (("params", state.params), ("mu", state.opt.mu),
                               ("nu", state.opt.nu), ("master", state.opt.master))}


@dataclasses.dataclass
class FSDPJob:
    """`steps` FSDP steps from `first` on this rank's layout, in float32.
    restore_from: start from that directory's whole state (resharded);
    save_to: save the final whole state there from rank 0's host."""
    arch: str
    steps: int = STEPS
    first: int = 0
    restore_from: Optional[str] = None
    save_to: Optional[str] = None

    def run(self, layout, device) -> dict:
        cfg = reduced(self.arch)
        _, whole = float32_state(cfg)
        if self.restore_from is not None:
            host, _ = restore_pytree(whole, self.restore_from)
            whole = host
        counting = layout.counting()
        specs = steps.state_shardings(layout, cfg, OPT, dp_over_model=True)
        state = failures.reshard(whole, counting,
                                 lambda path, leaf: rules.param_spec_dp(layout, path, leaf))
        parts = (state.params, state.opt.mu, state.opt.nu, state.opt.master)
        out = dict(held=layout.world.gather_objects(held_bytes(parts)), steps=[])
        step_fn = steps.make_train_step(cfg, OPT, remat=True, mesh=counting, dp_over_model=True)
        skeleton = M.LMModel(cfg, None, "meta")
        for i in range(self.first, self.first + self.steps):
            batch = steps.shard_batch(counting, make_batch(cfg, DATA, i, B, S, device), True)
            counting.reset_counts()
            with GradTap() as tap:
                state, metrics = step_fn(skeleton, state, batch)
            counts = counting.counts()
            grads = rules.unshard_tree(specs.params, tap.grads[0], group_of=counting.group)
            host = rules.gather_tree_to_host(specs, state, group_of=counting.group,
                                            coords=counting.coords)
            out["steps"].append(dict(counts=counts, grads={k: v.numpy() for k, v in grads.items()},
                                     state=None if host is None else numpy_state(host),
                                     **{k: float(v) for k, v in metrics.items()}))
        if host is not None and self.save_to is not None:
            save_pytree(host, self.save_to, self.first + self.steps)
        return out


@dataclasses.dataclass
class RoundTripJob:
    """A bf16 whole state as numpy (a checkpoint's host tree) resharded onto
    the layout and brought back to rank 0's host."""
    arch: str

    def run(self, layout, device) -> dict:
        L.ACT_DTYPE = torch.bfloat16
        cfg = configs.get(self.arch).reduced()
        whole = steps.init_train_state(M.init_params(cfg, 1, "cpu"), OPT)
        host = steps.TrainState(
            params={k: convert._to_numpy(v) for k, v in whole.params.items()},
            opt=adamw.OptState(*({k: convert._to_numpy(v) for k, v in t.items()}
                                 for t in whole.opt[:3]), convert._to_numpy(whole.opt.count)),
            step=convert._to_numpy(whole.step))
        specs = steps.state_shardings(layout, cfg, OPT, dp_over_model=True)
        placed = failures.reshard(host, layout,
                                  lambda path, leaf: rules.param_spec_dp(layout, path, leaf))
        held = held_bytes((placed.params, placed.opt.mu, placed.opt.nu, placed.opt.master))
        back = rules.gather_tree_to_host(specs, placed, group_of=layout.group,
                                        coords=layout.coords)
        same = None
        if back is not None:
            pairs = [(whole.params, back.params)] + list(zip(whole.opt[:3], back.opt[:3]))
            same = all(torch.equal(a[k].detach().reshape(-1).view(torch.uint8),
                                   b[k].reshape(-1).view(torch.uint8))
                       for a, b in pairs for k in a)
            same = same and int(back.opt.count) == 0 and int(back.step) == 0
        return dict(held=layout.world.gather_objects(held), same=same)


def single_device(arch, i, start=None):
    """Step `i` of the single-device float32 step from `start` (a whole state
    as `numpy_state` gives it; None: the fresh one): the metrics, the
    gradients and the state after it."""
    cfg = reduced(arch)
    model, state = float32_state(cfg)
    if start is not None:
        # copies: the step writes mu, nu and master in place
        t = {part: {k: torch.tensor(v) for k, v in tree.items()}
             for part, tree in start.items()}
        count = torch.tensor(i, dtype=torch.int32)
        state = steps.bind(model, steps.TrainState(
            t["params"], adamw.OptState(t["mu"], t["nu"], t["master"], count), count))
    with GradTap() as tap:
        state, metrics = steps.make_train_step(cfg, OPT, remat=True)(
            model, state, make_batch(cfg, DATA, i, B, S, "cpu"))
    return dict(grads={k: v.numpy() for k, v in tap.grads[0].items()},
                state=numpy_state(state), **{k: float(v) for k, v in metrics.items()})


_JAX_STEP_SCRIPT = r'''
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.launch import steps as S
from repro.launch.mesh import make_host_mesh
from repro.models import layers as L
from repro.optim import adamw
from repro.sharding import rules
L.ACT_DTYPE = jnp.float32
job = pickle.load(open(sys.argv[1], "rb"))
cfg, opt_cfg = configs.get(job["arch"]).reduced(), adamw.OptConfig(**job["opt"])
mesh = make_host_mesh(2, 2)
state_sh = S.state_shardings(mesh, cfg, opt_cfg, dp_over_model=True)
batch_sh = {k: NamedSharding(mesh, rules.data_spec(mesh, v.shape, include_model=True))
            for k, v in job["steps"][0]["batch"].items()}
tapped, update = {}, adamw.update
def tap(grads, *args, **kwargs):
    tapped["grads"] = grads
    return update(grads, *args, **kwargs)
adamw.update = tap
step = S.make_train_step(cfg, opt_cfg, remat=True, mesh=mesh, dp_over_model=True)
def step_and_grads(state, batch):
    new, metrics = step(state, batch)
    return new, metrics, tapped["grads"]
scalar = NamedSharding(mesh, P())
fn = jax.jit(step_and_grads, in_shardings=(state_sh, batch_sh),
             out_shardings=(state_sh, {k: scalar for k in ("loss", "grad_norm", "lr")},
                            state_sh.params))
out = []
for s in job["steps"]:
    t, o = s["state"], s["state"]["opt"]
    state = S.TrainState(params=t["params"], opt=adamw.OptState(o["mu"], o["nu"], o["master"],
                                                                 o["count"]), step=t["step"])
    state = jax.device_put(jax.tree.map(jnp.asarray, state), state_sh)
    with mesh:
        new, metrics, grads = fn(state, jax.device_put(s["batch"], batch_sh))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    out.append(dict(grads=to_np(grads), params=to_np(new.params), mu=to_np(new.opt.mu),
                    nu=to_np(new.opt.nu), master=to_np(new.opt.master),
                    **{k: float(v) for k, v in metrics.items()}))
pickle.dump(out, open(sys.argv[2], "wb"))
'''


def jax_sharded_steps(arch, starts, tmp):
    """The JAX package's sharded train step on a 2 x 2 host mesh (four
    forced host devices, a subprocess), one step from each whole start
    state (as `numpy_state` gives it) at that step's batch: the metrics,
    the gradients and the state after it, keyed by the port's names."""
    cfg, steps_in = reduced(arch), []
    for i, st in enumerate(starts):
        count = np.asarray(i, np.int32)
        tree = {part: convert._stack_named((k, torch.from_numpy(v)) for k, v in st[part].items())
                for part in st}
        steps_in.append(dict(
            state=dict(params=tree["params"], step=count,
                       opt=dict(mu=tree["mu"], nu=tree["nu"], master=tree["master"], count=count)),
            batch={k: v.numpy() for k, v in make_batch(cfg, DATA, i, B, S, "cpu").items()}))
    job, got = os.path.join(tmp, "job.pkl"), os.path.join(tmp, "out.pkl")
    with open(job, "wb") as f:
        pickle.dump(dict(arch=arch, opt=OPT_ARGS, steps=steps_in), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-c", _JAX_STEP_SCRIPT, job, got], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    with open(got, "rb") as f:
        out = pickle.load(f)
    return [dict(grads=convert._flat_named(o["grads"]),
                 state={p: convert._flat_named(o[p]) for p in ("params", "mu", "nu", "master")},
                 **{k: o[k] for k in ("loss", "grad_norm", "lr")}) for o in out]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    saved = str(tmp_path_factory.mktemp("elastic"))
    act = L.ACT_DTYPE
    try:
        four = run_ranks(4, [FSDPJob(a, save_to=saved if a == ARCHS[0] else None)
                             for a in ARCHS] + [RoundTripJob(ARCHS[1])],
                         "cpu", 120.0, 60.0, None, LAYOUTS["2x2"])
        survivors = failures.plan_elastic_mesh(2, 1)        # (data, model) of 2 ranks
        assert survivors == LAYOUTS["2x1"]
        fresh = numpy_state(float32_state(reduced(ARCHS[0]))[1])
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            two = pool.submit(run_ranks, 2, [FSDPJob(a) for a in ARCHS]
                              + [FSDPJob(ARCHS[0], steps=1, first=STEPS, restore_from=saved)],
                              "cpu", 120.0, 60.0, None, survivors)
            jax_ref = pool.submit(jax_sharded_steps, ARCHS[0],
                                  [fresh] + [s["state"] for s in four[0]["steps"][:-1]],
                                  str(tmp_path_factory.mktemp("jax_step")))
            results = {("2x2", a): r for a, r in zip(ARCHS, four)}
            refs = {key: refs_of(key[1], res) for key, res in results.items()}
            elastic_ref = single_device(ARCHS[0], STEPS, four[0]["steps"][-1]["state"])
            two, jax_ref = two.result(), jax_ref.result()
        for a, r in zip(ARCHS, two):
            results[("2x1", a)] = r
            refs[("2x1", a)] = refs_of(a, r)
    finally:
        L.ACT_DTYPE = act
    return dict(results=results, refs=refs, round_trip=four[-1], elastic=two[-1],
                elastic_ref=elastic_ref, jax_ref=jax_ref)


def refs_of(arch, res):
    """The single-device step from the state each of the layout's steps
    started from (the fresh one, then the layout's own)."""
    starts = [None] + [s["state"] for s in res["steps"][:-1]]
    return [single_device(arch, i, start) for i, start in enumerate(starts)]


def close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def check_step(got, want, tag):
    for k in ("loss", "grad_norm", "lr"):
        close(got[k], want[k], f"{tag} {k}")
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        close(got["grads"][k], g, f"{tag} grad {k}")


def update_slack(mu, nu, count):
    """The most AdamW's direction m^ / (sqrt(v^) + eps) at `count` can move
    when mu and nu each move by TOL of their leaf's largest magnitude (the
    bound they are held to): the largest change over the corners of that
    box, as the direction is monotone in each."""
    mu, nu = mu.astype(np.float64), nu.astype(np.float64)
    c1, c2 = 1 - OPT.b1 ** count, 1 - OPT.b2 ** count
    dm, dv = TOL * np.abs(mu).max(), TOL * nu.max()
    u = lambda m, v: (m / c1) / (np.sqrt(np.maximum(v, 0) / c2) + OPT.eps)
    base = u(mu, nu)
    return np.max([np.abs(u(mu + a, nu + b) - base) for a in (-dm, dm) for b in (-dv, dv)],
                  axis=0)


def check_state(got, want, tag, lr, count=None):
    """mu and nu within TOL of each leaf's largest magnitude; params and
    master too, at every element whose AdamW denominator sqrt(nu) is at
    least RESOLVED of the leaf's largest.  Below that the step divides the
    gradient's rounding noise by a value of the same size (the eps term
    included), so such an element is held within 2 lr, the most one step
    can move it.  With `count` (the step's optimizer count), params and
    master are held instead, element by element, within TOL of the leaf's
    largest plus lr times the change of the step's direction that mu and
    nu's own tolerance allows (`update_slack`), and never more than 2 lr."""
    for part, tree in want.items():
        assert set(got[part]) == set(tree)
        for k, v in tree.items():
            if part in ("mu", "nu"):
                close(got[part][k], v, f"{tag} {part} {k}")
                continue
            if count is not None:
                err = np.abs(got[part][k].astype(np.float64) - v)
                allowed = TOL * np.abs(v).max() + lr * np.minimum(
                    update_slack(want["mu"][k], want["nu"][k], count), 2.0)
                worst = np.argmax(err - allowed)
                assert err.flat[worst] <= allowed.flat[worst], \
                    f"{tag} {part} {k}: {err.flat[worst]} > {allowed.flat[worst]}"
                continue
            root = np.sqrt(want["nu"][k])
            sure = root >= RESOLVED * root.max()
            close(got[part][k][sure], v[sure], f"{tag} {part} {k}")
            err = np.abs(got[part][k][~sure].astype(np.float64) - v[~sure]).max(initial=0.0)
            assert err <= 2 * lr, f"{tag} {part} {k}: {err} where the gradient is noise"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fsdp_step_matches_single_device(runs, layout, arch):
    """Each step against the single-device step from the same state."""
    res, ref = runs["results"][(layout, arch)], runs["refs"][(layout, arch)]
    for i in range(STEPS):
        check_step(res["steps"][i], ref[i], f"{layout} {arch} step {i}")
        check_state(res["steps"][i]["state"], ref[i]["state"], f"{layout} {arch} step {i}",
                    ref[i]["lr"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_held_bytes_equal_spec_arithmetic(runs, layout, arch):
    """Every rank holds exactly its blocks of params, mu, nu and master
    (float32 here: 4 B an element), each in a storage of its own."""
    cfg = reduced(arch)
    whole = steps.abstract_params(cfg)
    sizes = LAYOUTS[layout]
    held = runs["results"][(layout, arch)]["held"]
    assert len(held) == math.prod(sizes)
    for r, h in enumerate(held):
        lay = mesh.shape_layout(sizes, r)
        want = 4 * 4 * sum(math.prod(rules.block_shape(rules.param_spec_dp(lay, (k,), v),
                                                       v.shape, lay)) for k, v in whole.items())
        assert h["tensors"] == want and h["storages"] == want, (r, h, want)
    n = sum(v.numel() for v in whole.values())
    assert held[0]["tensors"] < 16 * n                  # not the whole state


def units(cfg):
    """The name prefixes of each unit in the order the forward gathers them
    (the embedding, the layer units, the unembedding) and the layer units
    (those remat recomputes)."""
    if cfg.family in ("dense", "vlm", "audio", "ssm"):
        layers = [[f"layers.{i}"] for i in range(cfg.num_layers)]
    elif cfg.family == "moe":
        step, n_super = cfg.moe_layer_step, (cfg.num_layers - cfg.first_dense_layers) \
            // cfg.moe_layer_step
        layers = [[f"dense_prefix.{i}"] for i in range(cfg.first_dense_layers)]
        layers += [[f"dense_inter.{j}" for j in range(s * (step - 1), (s + 1) * (step - 1))]
                   + [f"layers.{s}"] for s in range(n_super)]
    else:                                   # hybrid: the shared block after every k-th layer
        k = cfg.shared_attn_every
        layers = []
        for i in range(cfg.num_layers):
            layers.append([f"layers.{i}"])
            if i % k == k - 1:
                layers.append(["shared_attn"])
    first = ["frontend"] if cfg.family == "audio" else ["embed"]
    last = ["embed"] if cfg.tie_embeddings else ["head"]
    return [first] + layers + [last], layers


def unit_bytes(cfg, sizes, prefixes):
    """The bytes one gather of a unit moves (float32): the group's size times
    one rank's blocks of the unit's cut leaves, padded to 8 bytes."""
    lay = mesh.shape_layout(sizes)
    own = 0
    for k, v in steps.abstract_params(cfg).items():
        if any(k.startswith(p + ".") for p in prefixes):
            spec = rules.param_spec_dp(lay, (k,), v)
            if any(e is not None for e in spec):
                own += 4 * math.prod(rules.block_shape(spec, v.shape, lay))
    return sizes[0] * (own + (-own % 8))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_census_one_gather_per_unit(runs, layout, arch):
    cfg, sizes = reduced(arch), LAYOUTS[layout]
    forward, recompute = units(cfg)
    sizes_fwd = [unit_bytes(cfg, sizes, u) for u in forward]
    sizes_re = [unit_bytes(cfg, sizes, u) for u in recompute]
    assert all(sizes_fwd), "every unit has weights to gather at this size"
    for step in runs["results"][(layout, arch)]["steps"]:
        c = step["counts"]["data"]
        assert c["gather"]["calls"] == len(forward) + len(recompute)
        assert c["gather"]["bytes"] == sum(sizes_fwd) + sum(sizes_re)
        assert c["gather"]["largest"] == max(sizes_fwd)
        whole = 4 * sum(v.numel() for v in steps.abstract_params(cfg).values())
        assert max(sizes_fwd) < whole                   # never the whole model at once
        # The gradients: one reduce-scatter per unit and dtype over data, the
        # rest summed over model and the world; no gather elsewhere.
        assert c["scatter_sum"]["calls"] >= len(forward)
        others = [v for k, v in step["counts"].items() if k != "data"]
        assert all(o["gather"]["calls"] == 0 for o in others)
        world = step["counts"]["data+model"]
        assert world["merge"]["calls"] >= 1


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_census_equals_the_dry_run(runs, layout, arch):
    """Every group's census, call for call and byte for byte, as the dry run
    traces the same DP-over-model step on meta tensors."""
    want = meta_census(reduced(arch), LAYOUTS[layout], "train", B, S, dp_over_model=True)
    for step in runs["results"][(layout, arch)]["steps"]:
        assert step["counts"] == want, (layout, arch)


def test_reshard_round_trip_same_bits(runs):
    res = runs["round_trip"]
    assert res["same"] is True
    cfg = configs.get(ARCHS[1]).reduced()
    for r, h in enumerate(res["held"]):
        want = steps.state_bytes_per_rank(mesh.shape_layout(LAYOUTS["2x2"], r), cfg, OPT, True)
        assert h["tensors"] == want and h["storages"] == want, (r, h, want)


def test_fsdp_step_matches_jax_sharded_step(runs):
    """qwen2's 2 x 2 steps against the JAX package's sharded step on a 2 x 2
    mesh from the same state and batch.  The two programs' gradients differ
    by their rounding (about 1e-6 of a leaf's largest), and AdamW's ratio
    magnifies that where mu cancels (0.9 mu + 0.1 g) or sqrt(nu) is small:
    params and master are held to what mu and nu's tolerance allows
    (`check_state(count=)`)."""
    res = runs["results"][("2x2", ARCHS[0])]
    for i, ref in enumerate(runs["jax_ref"]):
        check_step(res["steps"][i], ref, f"2x2 vs JAX step {i}")
        check_state(res["steps"][i]["state"], ref["state"], f"2x2 vs JAX step {i}", ref["lr"],
                    count=i + 1)


def test_elastic_restart_matches_single_device(runs):
    """Two steps at 2 x 2, then the survivors' (2, 1) layout from the saved
    state: the third step and the state after it as three single-device
    steps."""
    res, ref = runs["elastic"], runs["elastic_ref"]
    check_step(res["steps"][0], ref, "elastic step")
    check_state(res["steps"][0]["state"], ref["state"], "elastic", ref["lr"])
