"""The training checks shared by `test_torch_lm_train*.py`: one config at
reduced width, the reference's train step run op by op against the port's
loss, gradients and step (tolerances in `_torch_lm.py`)."""
import functools

import jax
import numpy as np
import torch

from _torch_lm import (GRAD_FLOOR, GRAD_FRAC, LOSS_TOL, assert_grads, at, jax_and_port,
                       jax_train_step, named_tree, reduced, tree_leaves)
from repro.data.pipeline import DataConfig as JDataConfig, make_batch as jmake_batch
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.launch import steps
from repro_torch.models import model as TM
from repro_torch.optim import adamw

B, S = 2, 16
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def run(name):
    """Everything the checks of one config read, computed once.  MoE configs
    run at capacity_factor 8, where no assignment overflows (a route flipped
    at a near tie would reorder the drops)."""
    cfg = reduced(name, capacity_factor=8.0)
    params, model = jax_and_port(cfg)
    batch = jax.tree.map(np.asarray, jmake_batch(cfg, JDataConfig(seed=5), 0, B, S))
    jnew, jmet, jgrads = jax_train_step(cfg, jadamw.OptConfig(**OPT), params, batch)

    tb = convert.batch_from_jax(batch, "cpu")
    names = [n for n, _ in model.named_parameters()]
    grads = {}
    for remat in (False, True):
        loss = TM.loss_fn(model, tb["inputs"], tb["labels"], remat=remat)
        grads[remat] = (loss.detach(), torch.autograd.grad(loss, list(model.parameters())))
    state = steps.init_train_state(model, adamw.OptConfig(**OPT))
    new, met = steps.make_train_step(cfg, adamw.OptConfig(**OPT), remat=False)(model, state, tb)
    return dict(cfg=cfg, jnew=jnew, jmet=jmet, jgrads=jgrads, names=names, grads=grads,
                new=convert.train_state_to_numpy(new), met={k: float(v) for k, v in met.items()})


def check_loss_and_gradients(name):
    r = run(name)
    loss, g = r["grads"][False]
    assert abs(float(loss) - r["jmet"]["loss"]) <= LOSS_TOL
    assert_grads(named_tree(zip(r["names"], g)), r["jgrads"])


def check_remat_bitwise(name):
    r = run(name)
    (l0, g0), (l1, g1) = r["grads"][False], r["grads"][True]
    assert torch.equal(l0, l1)
    for n, a, b in zip(r["names"], g0, g1):
        assert torch.equal(a, b), n


def check_train_step(name):
    """The step's metrics; mu and nu at the gradients' tolerance (nu is
    quadratic in g: twice it); master and params: an AdamW step is
    lr x (m/c1)/(sqrt(v/c2) + eps) ~ lr x sign(g) plus the decay, so an
    entry whose gradient sign the tolerance can flip may move 2 lr the
    other way, and every other entry agrees to float32 rounding."""
    r = run(name)
    jn, pn, jm, pm = r["jnew"], r["new"], r["jmet"], r["met"]
    assert abs(pm["loss"] - jm["loss"]) <= LOSS_TOL
    assert abs(pm["grad_norm"] - jm["grad_norm"]) <= GRAD_FRAC * jm["grad_norm"]
    assert pm["lr"] == jm["lr"]
    assert int(pn["step"]) == int(jn.step) == 1 and int(pn["opt"]["count"]) == 1
    assert_grads(pn["opt"]["mu"], jn.opt.mu)
    assert_grads(pn["opt"]["nu"], jn.opt.nu, frac=2.1 * GRAD_FRAC, floor=GRAD_FLOOR ** 2)
    lr = jm["lr"]
    top = max(np.abs(w).max() for _, w in tree_leaves(r["jgrads"]))
    for path, got in tree_leaves(pn["opt"]["master"]):
        want, g = at(jn.opt.master, path), at(r["jgrads"], path)
        p_got, p_want = at(pn["params"], path), at(jn.params, path)
        d = np.abs(got - want)
        assert d.max() <= 2 * lr * 1.001, (path, d.max())
        sure = np.abs(g) > GRAD_FRAC * max(np.abs(g).max(), GRAD_FLOOR * top)
        assert (d[sure] <= 1e-6 * np.abs(want[sure]) + 1e-9).all(), path
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(p_want), 1e-30))) - 7)
        assert (np.abs(p_got - p_want) <= 2 * lr * 1.001 + ulp).all(), path
