"""The port's training runtime: restart supervision with exact resumption,
straggler detection and elastic planning (`test_runtime.py` mirrored on
`repro_torch.runtime.failures`), bf16 `TrainState` checkpoints, and the
`TrainState` converters in both directions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import jax_and_port, reduced
from repro.launch.steps import TrainState as JTrainState
from repro.optim import adamw as jadamw
from repro_torch import configs, convert
from repro_torch.checkpoint import manager as ckpt
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import failures


def _fresh(cfg, opt_cfg):
    model = M.init_params(cfg, 0, "cpu")
    return model, steps.init_train_state(model, opt_cfg)


def _bits(a):
    return np.atleast_1d(np.asarray(a)).view(np.uint8)


def _assert_same_state(a, b):
    for x, y in zip(jax.tree.leaves(convert.train_state_to_numpy(a)),
                    jax.tree.leaves(convert.train_state_to_numpy(b)), strict=True):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_restart_resumes_exactly(tmp_path):
    """Train 10 steps with a crash injected at step 6 -> the final state of
    an uninterrupted run, bit for bit (deterministic pipeline, checkpoints
    that hold bf16 as its bits)."""
    cfg = configs.get("qwen2-0.5b").reduced(layers=1, d_model=32, vocab=64)
    opt_cfg = adamw.OptConfig(warmup_steps=2, total_steps=20)
    data = DataConfig(seed=3)
    step_fn = steps.make_train_step(cfg, opt_cfg, remat=False)

    model, state = _fresh(cfg, opt_cfg)
    for i in range(10):
        state, _ = step_fn(model, state, make_batch(cfg, data, i, 4, 16, "cpu"))
    ref = steps.clone_state(state)

    mgr = ckpt.CheckpointManager(str(tmp_path), keep=3, async_save=False)
    model, template = _fresh(cfg, opt_cfg)
    mgr.save(template, 0)
    crashed = {"done": False}

    def segment(start_step: int, ndev: int) -> int:
        restored, _ = mgr.restore(template, step=start_step)
        state = steps.bind(model, restored)
        for i in range(start_step, 10):
            if i == 6 and not crashed["done"]:
                crashed["done"] = True
                raise failures.TrainingFailure("injected device loss")
            state, _ = step_fn(model, state, make_batch(cfg, data, i, 4, 16, "cpu"))
            mgr.save(state, i + 1)
        return 10

    sup = failures.RestartSupervisor(lambda: ckpt.latest_step(str(tmp_path)), max_restarts=2)
    report = sup.run(segment, total_steps=10, num_devices=1)
    assert report.restarts == 1 and report.resumed_from == [6]
    assert report.completed_steps == 10
    final, step = mgr.restore(template)
    assert step == 10
    _assert_same_state(final, ref)


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save({"w": torch.zeros(1)}, 0)

    def always_fails(start, ndev):
        raise failures.TrainingFailure("boom")

    sup = failures.RestartSupervisor(lambda: ckpt.latest_step(str(tmp_path)), max_restarts=2)
    with pytest.raises(failures.TrainingFailure):
        sup.run(always_fails, total_steps=5, num_devices=1)


def test_straggler_monitor():
    mon = failures.StragglerMonitor(window=20, threshold=2.0)
    for i in range(20):
        assert mon.record(i, 0.1) is None
    ev = mon.record(20, 0.35)
    assert ev is not None and ev.ratio > 2.0
    assert len(mon.events) == 1
    # recovery: normal steps don't flag
    assert mon.record(21, 0.11) is None
    with mon.timed(22):
        pass
    assert len(mon.durations) == 23


def test_elastic_mesh_planning():
    assert failures.plan_elastic_mesh(256, 16) == (16, 16)
    assert failures.plan_elastic_mesh(240, 16) == (15, 16)   # lost a host
    assert failures.plan_elastic_mesh(512, 16, pod_size=256) == (2, 16, 16)
    with pytest.raises(ValueError):
        failures.plan_elastic_mesh(8, 16)


@pytest.mark.parametrize("master", [True, False])
def test_bf16_train_state_checkpoint_roundtrip(tmp_path, master):
    """A trained bf16 state (params, mu, nu, master or None, count, step)
    saved and restored into a fresh template bit for bit; async writes and
    retention as for the simulator's states."""
    cfg = configs.get("deepseek-v2-lite-16b").reduced(layers=2, d_model=32, vocab=64)
    opt_cfg = adamw.OptConfig(warmup_steps=1, total_steps=4, master_weights=master)
    model, state = _fresh(cfg, opt_cfg)
    step_fn = steps.make_train_step(cfg, opt_cfg, remat=False)
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for i in range(3):
        state, _ = step_fn(model, state, make_batch(cfg, DataConfig(), i, 2, 8, "cpu"))
        mgr.save(state, i + 1)
    mgr.wait()
    mgr.close()
    assert sorted(d for d in tmp_path.iterdir() if d.name.startswith("step_")) == \
        [tmp_path / "step_000000002", tmp_path / "step_000000003"]
    _, template = _fresh(cfg, opt_cfg)
    restored, step = ckpt.restore_pytree(template, str(tmp_path))
    assert step == 3 and int(restored.step) == 3 and int(restored.opt.count) == 3
    assert restored.params["embed.table"].dtype == torch.bfloat16
    assert (restored.opt.master is None) == (not master)
    _assert_same_state(restored, state)


def test_train_state_converters_both_ways():
    """A JAX TrainState (after one op-by-op AdamW update, so every leaf is
    non-trivial) into the port and back, bit for bit; the port's state
    drives its model."""
    cfg = reduced("zamba2-7b")
    params, _ = jax_and_port(cfg)
    opt_cfg = jadamw.OptConfig(warmup_steps=1)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    with jax.disable_jit():
        new_params, opt = jadamw.update(grads, jadamw.init(params, opt_cfg), params, opt_cfg)
    jstate = jax.tree.map(np.asarray, JTrainState(new_params, opt, jnp.asarray(7, jnp.int32)))
    model, state = convert.train_state_from_jax(jstate, cfg, "cpu")
    assert all(state.params[k] is p for k, p in model.named_parameters())
    assert int(state.step) == 7 and int(state.opt.count) == 1
    back = convert.train_state_to_numpy(state)
    want = {"params": jstate.params, "opt": {"mu": jstate.opt.mu, "nu": jstate.opt.nu,
                                             "master": jstate.opt.master,
                                             "count": jstate.opt.count},
            "step": jstate.step}
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
