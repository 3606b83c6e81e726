"""The port stands alone: no module of `src/repro_torch/`, and not
`chip_smoke.py`, imports JAX or the JAX package; and its entry points run
on the CUDA card unless the caller asks for the CPU, raising without one."""
import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert, device
from repro_torch.core import engine, ensemble, noise, streams

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    banned = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not banned, f"{path} imports {sorted(banned)}"


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "msp_update.py", "m2l_pair.py", "gaussian_nbody.py",
            "barnes_hut.py", "direct.py", "analysis.py", "ensemble.py", "probes.py",
            "manager.py", "sweep.py", "chip_smoke.py", "streams.py", "session.py",
            "batcher.py", "service.py", "serve.py", "distributed.py", "mesh.py", "rules.py",
            "brain_dryrun.py", "report.py", "astlint.py", "tracer.py", "bad_examples.py",
            "cli.py", "__main__.py", "config.py", "layers.py", "attention.py", "moe.py",
            "mamba2.py", "model.py", "steps.py", "lm_serve.py", "deepseek_v2_lite_16b.py",
            "llama4_maverick_400b_a17b.py", "chameleon_34b.py", "yi_6b.py", "qwen2_0_5b.py",
            "qwen3_8b.py", "internlm2_1_8b.py", "zamba2_7b.py", "hubert_xlarge.py",
            "mamba2_1_3b.py", "convert.py", "adamw.py", "pipeline.py", "failures.py",
            "lm_train.py", "hints.py", "tp.py", "dryrun.py"} <= names
    assert {"audit", "launch", "sharding", "serve", "core", "kernels", "checkpoint", "models",
            "configs", "optim", "data", "runtime"} <= {p.parent.name for p in PORT_FILES}


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_entry_points_default_to_cuda_and_raise_without_it(no_card):
    pos = np.zeros((8, 3), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve()
    with pytest.raises(RuntimeError, match="cuda"):
        engine.PlasticityEngine(pos)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.from_jax_state({})
    with pytest.raises(RuntimeError):
        noise.GeneratorNoise(0, device.resolve("cuda"))
    with pytest.raises(RuntimeError, match="cuda"):
        streams.CounterNoise(0)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.build_service(16, num_slots=1, round_steps=100, checkpoint_dir="unused")
    from repro_torch.core.distributed import DistributedPlasticityEngine
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="cuda"):
        DistributedPlasticityEngine(pos, mesh.ShapeGroup(1))
    with pytest.raises(RuntimeError, match="cuda"):    # NCCL needs the card: no gloo fallback
        mesh.make_data_group("file:///nonexistent/rendezvous", 0, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_ensemble_group("file:///nonexistent/rendezvous", 0, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_sweep_groups(1, 1, "file:///nonexistent/rendezvous")
    from repro_torch.launch.distributed import run_ranks
    with pytest.raises(RuntimeError, match="cuda"):     # before any rank is spawned
        run_ranks(1, [])
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_batch
    with pytest.raises(RuntimeError, match="cuda"):
        make_batch(configs.get("qwen2-0.5b").reduced(), DataConfig(), 0, 1, 4)
    from repro_torch.launch import lm_train
    with pytest.raises(RuntimeError, match="cuda"):
        lm_train.main(["--steps", "1"])
    assert device.resolve("cpu") == torch.device("cpu")


def _unported(option, mesh):
    """Build the entry point with a replica mesh (ported in the sixth slice)."""
    pos = np.random.default_rng(0).uniform(0, 1000.0, (16, 3)).astype(np.float32)
    eng = engine.PlasticityEngine(pos, device="cpu")
    if option == "ensemble-mesh":
        return ensemble.EnsembleEngine(eng, mesh=mesh).init_states(4)
    from repro_torch.serve import SimulationService
    return SimulationService(pos, eng.msp_cfg, eng.fmm_cfg, num_slots=4, round_steps=100,
                             checkpoint_dir="unused", mesh=mesh, device="cpu")


@pytest.mark.parametrize("option", ["ensemble-mesh", "service-mesh"])
def test_unported_options_raise_not_implemented(option):
    """The replica mesh that used to raise NotImplementedError is ported: a
    mesh of 2 holds half the replicas or slots, one of 3 raises ValueError
    (it does not divide 4); rng="counter" and n_active construct."""
    from repro_torch.launch.mesh import ShapeGroup
    built = _unported(option, ShapeGroup(2, 1, name="ensemble"))
    held = built.dropped.shape[0] if option == "ensemble-mesh" else built.states.dropped.shape[0]
    assert held == 2
    with pytest.raises(ValueError, match="divide"):
        _unported(option, ShapeGroup(3, name="ensemble"))
    assert engine.EngineConfig(rng="counter").rng == "counter"


@pytest.mark.parametrize("method", ["fmm", "barnes_hut"])
def test_m2m_pyramid_constructs_and_builds(method):
    """EngineConfig(pyramid="m2m") is ported: it constructs, and an engine
    built with it runs a connectivity update on the CPU."""
    cfg = engine.EngineConfig(pyramid="m2m", method=method)
    rng = np.random.default_rng(0)
    eng = engine.PlasticityEngine(rng.uniform(0, 1000.0, (64, 3)).astype(np.float32),
                                  engine_cfg=cfg, device="cpu")
    st = eng.init_state()
    st = st._replace(neurons=st.neurons._replace(ax_elems=st.neurons.ax_elems + 3,
                                                 den_elems=st.neurons.den_elems + 3))
    st = eng.connectivity_update(st, noise.GeneratorNoise(0, torch.device("cpu")), 0)
    assert int(st.edges.valid.sum()) > 0
