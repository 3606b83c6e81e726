"""The LM training path of the port against the JAX package on the CPU, for
the MoE configs at reduced width (checks in `_torch_lm_train.py`, as
`test_torch_lm_train.py` runs them for the dense ones and
`test_torch_lm_train_ssm.py` for the SSM and hybrid ones); and one MoE
layer's gradients where assignments overflow."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import GRAD_FLOOR, GRAD_FRAC_F32, assert_grads, load, named_tree, reduced
from _torch_lm_train import check_loss_and_gradients, check_remat_bitwise, check_train_step
from repro import configs as jax_configs
from repro.models import moe as JE
from repro_torch.models import moe as TE

NAMES = sorted(n for n, c in jax_configs.ARCHS.items() if c.family == "moe")


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(name):
    check_loss_and_gradients(name)


@pytest.mark.parametrize("name", NAMES)
def test_remat_equals_no_remat_bitwise(name):
    check_remat_bitwise(name)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name):
    check_train_step(name)


@pytest.mark.parametrize("name", NAMES)
def test_moe_layer_gradients_with_dropped_tokens(name):
    """One MoE layer in float32 at capacity_factor 1.25, on rows that crowd a
    few experts so that assignments overflow: the cotangents of x, the
    router, the experts and the shared experts against `jax.vjp` of the
    reference's layer, within 1e-4 of each leaf's largest |g| (with the
    rounding-noise floor of `_torch_lm.py`), once the routes agree."""
    cfg = reduced(name, 1.25)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), JE.moe_init(jax.random.key(0), cfg))
    tp = load(TE.MoE(cfg, None, "cpu").float(), jp)
    rng = np.random.default_rng(4)
    x = (4.0 * rng.normal(size=(1, 1, cfg.d_model))
         + rng.normal(size=(2, 32, cfg.d_model))).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    _, expert, _ = TE.route(tp, torch.from_numpy(x), cfg)
    cap = TE._capacity(32, cfg)
    assert not bool(TE.dispatch(expert, cfg.num_experts, cap).keep.all())   # drops
    out_j, vjp = jax.vjp(lambda p, x: JE.moe_apply(p, x, cfg), jp, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = TE.moe_apply(tp, xt, cfg)
    names = [n for n, _ in tp.named_parameters()]
    g = torch.autograd.grad(out_t, [xt] + list(tp.parameters()), torch.from_numpy(ct))
    out_j = np.asarray(out_j)     # float32 sums in another order: 1e-5 of the largest
    assert np.abs(out_t.detach().numpy() - out_j).max() <= 1e-5 * np.abs(out_j).max()
    want = dict(jax.tree.map(np.asarray, gp_j), x=np.asarray(gx_j))
    got = dict(named_tree(zip(names, g[1:])), x=g[0].numpy())
    if cfg.top_k == 1:
        # the gate is g / g = 1: the router's cotangent is zero, and both
        # sides hold float32 rounding noise, under 1e-6 of the largest |g|
        top = max(np.abs(w).max() for w in jax.tree.leaves(want))
        for tree in (got, want):
            assert np.abs(tree.pop("router")).max() <= 1e-6 * top
    assert_grads(got, want, frac=GRAD_FRAC_F32, floor=GRAD_FLOOR)
