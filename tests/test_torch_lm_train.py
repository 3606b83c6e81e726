"""The LM training path of the port against the JAX package on the CPU, for
the dense, vlm and audio configs at reduced width (the MoE, SSM and hybrid
ones: `test_torch_lm_train_moe.py`): `loss_fn` and every gradient leaf
against the reference's `value_and_grad` run op by op, remat equal bit for
bit to no remat, one `make_train_step` against the reference's; and
`silu`'s gradient, the float32 run and the training run of
`test_training_reduces_loss`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (GRAD_FRAC_F32, assert_grads, jax_and_port, labels, named_tree,
                       reduced)
from _torch_lm_train import check_loss_and_gradients, check_remat_bitwise, check_train_step
from repro import configs as jax_configs
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

NAMES = sorted(n for n, c in jax_configs.ARCHS.items() if c.family in ("dense", "vlm", "audio"))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(name):
    check_loss_and_gradients(name)


@pytest.mark.parametrize("name", NAMES)
def test_remat_equals_no_remat_bitwise(name):
    check_remat_bitwise(name)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name):
    check_train_step(name)


def test_silu_gradient_matches_jax_grad():
    """Every bf16 gradient equal to jax.grad's op by op (the logistic rule
    on the rounded logistic), over values that cover the bf16 range in use."""
    x = np.concatenate([np.linspace(-12, 12, 4001), np.random.default_rng(0).normal(
        scale=3, size=4000)]).astype(np.float32)
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16).requires_grad_()
    gj, gt = jnp.asarray(g, jnp.bfloat16), torch.tensor(g).to(torch.bfloat16)
    with jax.disable_jit():
        _, vjp = jax.vjp(jax.nn.silu, xj)
        want = np.asarray(vjp(gj)[0], np.float32)
    got = torch.autograd.grad(TL.silu(xt), xt, gt)[0].float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["qwen2-0.5b"])
def test_float32_loss_and_gradients_match_reference(name, monkeypatch):
    """Parameters and activations in float32 on both sides: the loss within
    1e-5 and every gradient leaf within 1e-4 of its largest |g|."""
    cfg = reduced(name)
    params, model = jax_and_port(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = model.float()
    monkeypatch.setattr(JL, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "ACT_DTYPE", torch.float32)
    x = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lab = labels(cfg, 2, 16)
    with jax.disable_jit():
        jl, jg = jax.value_and_grad(
            lambda p: JM.loss_fn(p, jnp.asarray(x), jnp.asarray(lab), cfg))(params)
    loss = TM.loss_fn(model, torch.from_numpy(x), torch.from_numpy(lab))
    g = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(float(loss) - float(jl)) <= 1e-5
    assert_grads(named_tree(zip([n for n, _ in model.named_parameters()], g)),
                 jax.tree.map(np.asarray, jg), frac=GRAD_FRAC_F32)


def test_training_reduces_loss():
    """The reference's `test_training_reduces_loss` on the port: a 2-layer
    qwen2 on the Markov stream, 30 steps of AdamW; the loss drops by 0.5."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import adamw

    cfg = configs.get("qwen2-0.5b").reduced(layers=2, d_model=64, vocab=128)
    opt_cfg = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=60)
    model = TM.init_params(cfg, 0, "cpu")
    state = init_train_state(model, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, remat=False)
    data = DataConfig(seed=0)
    losses = []
    for i in range(30):
        state, metrics = step_fn(model, state, make_batch(cfg, data, i, 8, 32, "cpu"))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses
    assert np.isfinite(losses).all()
