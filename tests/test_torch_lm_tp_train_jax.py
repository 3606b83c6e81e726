"""The tensor-parallel train step on a 2 x 2 gloo layout against the JAX
package's own: `make_train_step(mesh=make_host_mesh(2, 2),
dp_over_model=False)`, jitted with `state_shardings(dp_over_model=False)`
and the batch over the data axis only, on four forced host devices in a
subprocess (as `test_torch_lm_mesh_gloo.py::jax_sharded_steps` does for the
DP posture).

Reduced qwen2-0.5b, deepseek-v2-lite-16b (capacity 8) and zamba2-7b, two
steps each in float32 with remat: the first from the fresh state, the
second from the layout's own state after it, both programs from the same
state and batch.  The loss, the grad norm, every gradient leaf, mu and nu
within 1e-5 of each leaf's largest magnitude; params and master within
what mu and nu's tolerance allows AdamW's direction to move
(`check_state(count=)`).  One `run_ranks` call (a 120 s limit, a 60 s
collective timeout), then one JAX subprocess for the three configs.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_lm_tp_train import ARCHS, TPJob, config, float32_state
from repro_torch import convert
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.distributed import run_ranks
from repro_torch.models import layers as L
from test_torch_lm_mesh_gloo import B, DATA, OPT_ARGS, S, check_state, check_step, numpy_state

SIZES = (2, 2)

_JAX_TP_STEP_SCRIPT = r'''
import dataclasses, os, pickle, sys
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
jobs = pickle.load(open(sys.argv[1], "rb"))
mesh = make_host_mesh(2, 2)
tapped, update = {}, adamw.update
def tap(grads, *args, **kwargs):
    tapped["grads"] = grads
    return update(grads, *args, **kwargs)
adamw.update = tap
result = {}
for arch, job in jobs.items():
    cfg = dataclasses.replace(configs.get(arch).reduced(), **job["extra"])
    opt_cfg = adamw.OptConfig(**job["opt"])
    state_sh = S.state_shardings(mesh, cfg, opt_cfg, dp_over_model=False)
    batch_sh = {k: NamedSharding(mesh, rules.data_spec(mesh, v.shape))
                for k, v in job["steps"][0]["batch"].items()}
    step = S.make_train_step(cfg, opt_cfg, remat=True, mesh=mesh, dp_over_model=False)
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
        state = S.TrainState(params=t["params"],
                             opt=adamw.OptState(o["mu"], o["nu"], o["master"], o["count"]),
                             step=t["step"])
        state = jax.device_put(jax.tree.map(jnp.asarray, state), state_sh)
        with mesh:
            new, metrics, grads = fn(state, jax.device_put(s["batch"], batch_sh))
        to_np = lambda tree: jax.tree.map(np.asarray, tree)
        out.append(dict(grads=to_np(grads), params=to_np(new.params), mu=to_np(new.opt.mu),
                        nu=to_np(new.opt.nu), master=to_np(new.opt.master),
                        **{k: float(v) for k, v in metrics.items()}))
    result[arch] = out
pickle.dump(result, open(sys.argv[2], "wb"))
'''


def jax_tp_steps(starts, tmp):
    """The JAX package's tensor-parallel step on a 2 x 2 host mesh, per arch
    one step from each whole start state (as `numpy_state` gives it) at
    that step's batch: the metrics, the gradients and the state after it,
    keyed by the port's names."""
    jobs = {}
    for arch, states in starts.items():
        cfg, steps_in = config(arch), []
        for i, st in enumerate(states):
            count = np.asarray(i, np.int32)
            tree = {part: convert._stack_named((k, torch.from_numpy(v))
                                               for k, v in st[part].items()) for part in st}
            steps_in.append(dict(
                state=dict(params=tree["params"], step=count,
                           opt=dict(mu=tree["mu"], nu=tree["nu"], master=tree["master"],
                                    count=count)),
                batch={k: v.numpy() for k, v in make_batch(cfg, DATA, i, B, S, "cpu").items()}))
        extra = dict(capacity_factor=cfg.capacity_factor) if cfg.num_experts else {}
        jobs[arch] = dict(extra=extra, opt=OPT_ARGS, steps=steps_in)
    job, got = os.path.join(tmp, "job.pkl"), os.path.join(tmp, "out.pkl")
    with open(job, "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-c", _JAX_TP_STEP_SCRIPT, job, got], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(got, "rb") as f:
        out = pickle.load(f)
    return {arch: [dict(grads=convert._flat_named(o["grads"]),
                        state={p: convert._flat_named(o[p])
                               for p in ("params", "mu", "nu", "master")},
                        **{k: o[k] for k in ("loss", "grad_norm", "lr")}) for o in steps]
            for arch, steps in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    act = L.ACT_DTYPE
    try:
        port = run_ranks(4, [TPJob(a) for a in ARCHS], "cpu", 120.0, 60.0, None, SIZES)
        port = dict(zip(ARCHS, port))
        starts = {a: [numpy_state(float32_state(config(a))[1])]
                  + [s["state"] for s in port[a]["steps"][:-1]] for a in ARCHS}
        return dict(port=port, jax=jax_tp_steps(starts, str(tmp_path_factory.mktemp("jax_tp"))))
    finally:
        L.ACT_DTYPE = act


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_jax_sharded_step(runs, arch):
    """The two programs' gradients differ by their rounding (about 1e-6 of
    a leaf's largest); AdamW's ratio magnifies that where mu cancels or
    sqrt(nu) is small, so params and master are held to what mu and nu's
    tolerance allows."""
    res = runs["port"][arch]
    for i, ref in enumerate(runs["jax"][arch]):
        check_step(res["steps"][i], ref, f"2x2 vs JAX {arch} step {i}")
        check_state(res["steps"][i]["state"], ref["state"], f"2x2 vs JAX {arch} step {i}",
                    ref["lr"], count=i + 1)
