"""Serving over a 2 x 2 layout against the JAX package's own sharded steps.

The reference's `make_prefill_step(cfg, mesh)` and `make_decode_step(cfg,
mesh)` run jitted with `param_shardings(mesh, cfg, serve=True)`,
`cache_shardings` and `logits_shardings` on `make_host_mesh(2, 2)` (four
forced host devices, a subprocess), in float32, from the port's seeded
weights and the same tokens: a prefill of 9 tokens into caches of 16
positions, then six decode steps.  The port runs the same on four spawned
gloo ranks (`run_ranks(..., lm=(2, 2))`).  For qwen2-0.5b (GQA),
deepseek-v2-lite-16b (MLA + MoE) and zamba2-7b (Mamba2 + shared
attention), the logits of every step and every cache leaf agree within
1e-5 of each leaf's largest magnitude.
"""
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from _torch_lm_tp import (DECODES, PROMPT, Case, ServeJob, check_case, config, float32_model,
                          inputs)
from repro_torch import convert
from repro_torch.launch.distributed import run_ranks
from repro_torch.models import layers as L

ARCHS = ["qwen2-0.5b", "deepseek-v2-lite-16b", "zamba2-7b"]
CASES = tuple(Case(a) for a in ARCHS)

_JAX_SERVE_SCRIPT = r'''
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
from repro.models import model as M
L.ACT_DTYPE = jnp.float32
job = pickle.load(open(sys.argv[1], "rb"))
mesh = make_host_mesh(2, 2)
to_np = lambda tree: jax.tree.map(np.asarray, tree)
out = {}
for arch, c in job["cases"].items():
    cfg = configs.get(arch).reduced()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    toks, b, s = c["tokens"], c["tokens"].shape[0], job["max_seq"]
    psh, csh = S.param_shardings(mesh, cfg, serve=True), S.cache_shardings(mesh, cfg, b, s)
    lsh = S.logits_shardings(mesh, cfg, b)
    bsh = lambda x: NamedSharding(mesh, S.rules.data_spec(mesh, x.shape))
    params = jax.device_put(jax.tree.map(jnp.asarray, c["params"]), psh)
    caches = jax.device_put(M.make_cache(cfg, b, s), csh)
    prompt = toks[:, :job["prompt"]]
    prefill = jax.jit(S.make_prefill_step(cfg, mesh), in_shardings=(psh, csh, {"inputs": bsh(prompt)}),
                      out_shardings=(lsh, csh))
    with mesh:
        logits, caches = prefill(params, caches, {"inputs": jax.device_put(prompt, bsh(prompt))})
    steps_out = [np.asarray(logits)]
    tok0 = toks[:, :1]
    decode = jax.jit(S.make_decode_step(cfg, mesh),
                     in_shardings=(psh, csh, {"token": bsh(tok0), "cache_pos": NamedSharding(mesh, P())}),
                     out_shardings=(lsh, csh))
    for i in range(job["decodes"]):
        pos = job["prompt"] + i
        tok = toks[:, pos:pos + 1]
        with mesh:
            logits, caches = decode(params, caches, {"token": jax.device_put(tok, bsh(tok)),
                                                     "cache_pos": jnp.asarray(pos, jnp.int32)})
        steps_out.append(np.asarray(logits))
    out[arch] = dict(logits=steps_out, caches=to_np(caches))
pickle.dump(out, open(sys.argv[2], "wb"))
'''


def jax_sharded(tmp):
    cases = {}
    for case in CASES:
        cfg = config(case.arch)
        cases[case.arch] = dict(params=convert.lm_params_to_numpy(float32_model(cfg)),
                                tokens=inputs(cfg, case).numpy())
    job, got = os.path.join(tmp, "job.pkl"), os.path.join(tmp, "out.pkl")
    with open(job, "wb") as f:
        pickle.dump(dict(cases=cases, max_seq=CASES[0].max_seq, prompt=PROMPT, decodes=DECODES),
                    f)
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-c", _JAX_SERVE_SCRIPT, job, got], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(got, "rb") as f:
        out = pickle.load(f)
    return {a: dict(logits=o["logits"], caches={
        grp: [{k: np.asarray(v)[i] for k, v in leaves.items()}
              for i in range(next(iter(leaves.values())).shape[0])]
        for grp, leaves in o["caches"].items()}) for a, o in out.items()}


@pytest.fixture(scope="module")
def runs():
    import concurrent.futures
    act = L.ACT_DTYPE
    try:
        with tempfile.TemporaryDirectory(prefix="lm_tp_jax_") as tmp, \
                concurrent.futures.ThreadPoolExecutor(1) as pool:
            port = pool.submit(run_ranks, 4, [ServeJob(CASES)], "cpu", 300.0, 60.0, None, (2, 2))
            ref = jax_sharded(tmp)
            return dict(port=port.result()[0], jax=ref)
    finally:
        L.ACT_DTYPE = act


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_layout_matches_jax_sharded_steps(runs, case):
    check_case(runs["port"][case], runs["jax"][case.arch], f"2x2 vs JAX {case.name}")
