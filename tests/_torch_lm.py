"""Shared helpers of the LM substrate's port tests (`tests/test_torch_lm_*.py`):
JAX parameters carried into the port, seeded inputs, and the comparisons
with their tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import model as JM
from repro_torch import convert

ARCH_NAMES = sorted(jax_configs.ARCHS)


def reduced(name, capacity_factor=None):
    cfg = jax_configs.get(name).reduced()
    if capacity_factor is not None and cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def jax_and_port(cfg, seed=0):
    """JAX's init_params and the port's model holding the same leaves."""
    params = JM.init_params(jax.random.key(seed), cfg)
    model = convert.lm_params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    return params, model


@pytest.fixture
def no_grad():
    """The forward checks of the serving path hold values only: they run
    without an autograd graph (the parameters are trainable)."""
    with torch.no_grad():
        yield


def load(module, tree):
    """Fill an uninitialised port module (built with gen=None) with a JAX
    subtree of the same layout (no stacked leaves), bit for bit."""
    flat = {".".join(p): v for p, v in convert._leaves(jax.tree.map(np.asarray, tree))}
    params = dict(module.named_parameters())
    assert set(flat) == set(params), set(flat) ^ set(params)
    for name, p in params.items():
        p.data.copy_(convert._to_torch(flat[name]))
    return module


def inputs(cfg, b, s, seed=1):
    """Token ids (B, S) int32, or frame features (B, S, F) float32 for audio."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def bf16(a):
    """numpy float -> JAX's numpy bfloat16 and the port's torch bfloat16."""
    a = np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)
    return jnp.asarray(a), convert._to_torch(a)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_ulps(got, want, ulps=1, equal_frac=0.999):
    """bf16 outputs of the same arithmetic: at most `ulps` bf16 ulps of the
    row's largest magnitude apart (a product's small outputs inherit its
    inputs' rounding), and at least `equal_frac` of them equal (an ulp of
    float32 exp/rsqrt/cos between torch and XLA can flip a bf16 rounding now
    and then)."""
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    top = np.max(np.maximum(np.abs(g), np.abs(w)), axis=-1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    d = np.abs(g - w)
    assert np.all(d <= ulps * ulp), f"max {np.max(d / ulp):.1f} ulps"
    assert np.mean(d == 0) >= equal_frac, f"only {np.mean(d == 0):.4f} equal"


def assert_logits(got, want, max_abs, mean_abs):
    """float32 logits computed from bf16 activations: the compiled reference
    fuses residual adds into the next norm (skipping their bf16 rounding),
    so the two drift apart by a few bf16 ulps; max and mean |diff| bound it."""
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    d = np.abs(g - w)
    assert d.max() <= max_abs and d.mean() <= mean_abs, (d.max(), d.mean())


def log_softmax(a):
    a = np.asarray(a, np.float64)
    m = a.max(-1, keepdims=True)
    return a - m - np.log(np.exp(a - m).sum(-1, keepdims=True))


def _jax_run(params, cfg, toks, s, extra):
    """JAX's forward_train logits; then prefill and `extra` decode steps:
    their logits and the caches after prefill and after the last step."""
    full = np.asarray(JM.forward_train(params, jnp.asarray(toks), cfg))
    if not cfg.supports_decode:
        return full, [], []
    c = JM.make_cache(cfg, toks.shape[0], s + extra)
    lg, c = JM.forward_prefill(params, jnp.asarray(toks[:, :s]), cfg, c)
    logits, caches = [np.asarray(lg)], [jax.tree.map(np.asarray, c)]
    for pos in range(s, s + extra):
        lg, c = JM.forward_decode(params, jnp.asarray(toks[:, pos:pos + 1]), cfg, c,
                                  jnp.asarray(pos, jnp.int32))
        logits.append(np.asarray(lg))
    return full, logits, caches + [jax.tree.map(np.asarray, c)]


@torch.no_grad()
def _port_run(model, toks, s, extra):
    from repro_torch.models import model as TM
    full = TM.forward_train(model, torch.from_numpy(toks)).numpy()
    if not model.cfg.supports_decode:
        return full, [], []
    c = TM.make_cache(model.cfg, toks.shape[0], s + extra, "cpu")
    lg, c = TM.forward_prefill(model, torch.from_numpy(toks[:, :s]), c)
    logits, caches = [lg.numpy()], [convert.lm_cache_to_numpy(c)]
    for pos in range(s, s + extra):
        lg, c = TM.forward_decode(model, torch.from_numpy(toks[:, pos:pos + 1]), c, pos)
        logits.append(lg.numpy())
    return full, logits, caches + [convert.lm_cache_to_numpy(c)]


def check_whole_model(name, b=2, s=16, extra=3):
    """One config at reduced width, JAX's parameters carried across:
    forward_train's logits, prefill's logits and caches, and `extra` decode
    steps' logits and caches.

    * Against the reference run op by op (`jax.disable_jit()`: its scans and
      conds as Python loops, each op as the port runs it): logits within
      0.05 (about two bf16 ulps at |logit| 4; an ulp of float32 exp or
      rsqrt between torch and XLA can flip a bf16 rounding), cache leaves
      within 2 % of the leaf's largest magnitude.
    * Against the reference as compiled (its scans fuse residual adds into
      the next norm, skipping their bf16 rounding): within 0.2, mean 0.02,
      on every token where the compiled reference is within 0.2 of its own
      op-by-op run; it may not be on a token whose near-tied route it flips
      (at most 5 % of them).
    * The port's decode against its own forward_train at the reference
      test's bound: max |log-softmax diff| < 0.25.

    MoE configs run at capacity_factor 8, so no assignment overflows: a
    flipped route at 1.25 would reorder the drops of the tokens after it.
    `test_torch_lm_moe.py` holds the drops against JAX's layer."""
    cfg = reduced(name, capacity_factor=8.0)
    params, model = jax_and_port(cfg)
    toks = inputs(cfg, b, s + extra)
    with jax.disable_jit():
        eager = _jax_run(params, cfg, toks, s, extra)
    compiled = _jax_run(params, cfg, toks, s, extra)
    port = _port_run(model, toks, s, extra)

    for got, want in zip([port[0]] + port[1], [eager[0]] + eager[1]):
        assert_logits(got, want, 0.05, 0.005)
    for got, want in zip(port[2], eager[2]):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, c in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            a, c = np.asarray(a, np.float32), np.asarray(c, np.float32)
            assert np.abs(a - c).max() <= 0.02 * np.abs(c).max(), (np.abs(a - c).max(),
                                                                   np.abs(c).max())
    for got, ref, want in zip([port[0]] + port[1], [eager[0]] + eager[1],
                              [compiled[0]] + compiled[1]):
        same = np.abs(ref - want).max(-1) <= 0.2
        assert same.mean() >= 0.95
        assert_logits(got[same], want[same], 0.2, 0.02)

    full, steps = port[0], port[1]
    errs = [np.abs(log_softmax(lg[:, 0]) - log_softmax(full[:, pos - 1])).max()
            for pos, lg in zip(range(s, s + extra + 1), steps)]
    assert max(errs or [0]) < 0.25, errs


# ---------------------------------------------------------------------------
# Training (the loss, its gradients and one AdamW step)
# ---------------------------------------------------------------------------

# bf16 runs of the port and the reference op by op: the loss within 0.05
# (the logits' bound); every gradient leaf within GRAD_FRAC of its largest
# |g| (bf16 activations summed in another order: observed up to 1.5 %).  A
# leaf whose whole gradient is float32 rounding noise (llama4's top-1
# router: gate / sum(gate) is 1 whatever the probabilities) is held at
# GRAD_FLOOR of the largest |g| of all leaves instead of its own.  float32
# runs of both are held at GRAD_FRAC_F32.
LOSS_TOL, GRAD_FRAC, GRAD_FLOOR, GRAD_FRAC_F32 = 0.05, 0.05, 1e-6, 1e-4


def labels(cfg, b, s, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def named_tree(named):
    """(name, tensor) pairs as the reference's nested numpy tree."""
    return convert._stack_named(named)


def tree_leaves(tree, prefix=()):
    """(path, float32 numpy leaf) pairs of a nested dict."""
    for path, leaf in convert._leaves(tree, prefix):
        yield path, np.asarray(leaf, np.float32)


def at(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree, np.float32)


def assert_grads(got, want, frac=GRAD_FRAC, floor=GRAD_FLOOR):
    """Every leaf of `got` (a numpy tree) within frac x max(its reference
    leaf's max |g|, floor x the largest |g| of all leaves)."""
    top = max(np.abs(w).max() for _, w in tree_leaves(want))
    paths = sorted(p for p, _ in tree_leaves(got))
    assert paths == sorted(p for p, _ in tree_leaves(want))
    for path, g in tree_leaves(got):
        w = at(want, path)
        scale = max(np.abs(w).max(), floor * top)
        err = np.abs(g - w).max()
        assert err <= frac * scale, (path, err, scale)


class GradTap:
    """While active, records the gradients that the reference's train step
    hands to `adamw.update` (its module attribute is wrapped)."""

    def __enter__(self):
        from repro.optim import adamw
        self.grads, self._update = None, adamw.update

        def update(grads, *args, **kwargs):
            self.grads = grads
            return self._update(grads, *args, **kwargs)
        adamw.update = update
        return self

    def __exit__(self, *exc):
        from repro.optim import adamw
        adamw.update = self._update


def jax_train_step(cfg, opt_cfg, params, batch, remat=False):
    """The reference's make_train_step run op by op from a fresh state:
    (new state as numpy, metrics as floats, gradients as numpy)."""
    from repro.launch.steps import TrainState, make_train_step
    from repro.optim import adamw
    state = TrainState(params=params, opt=adamw.init(params, opt_cfg),
                       step=jnp.zeros((), jnp.int32))
    step = make_train_step(cfg, opt_cfg, remat=remat)
    with jax.disable_jit(), GradTap() as tap:
        new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return to_np(new), {k: float(v) for k, v in metrics.items()}, to_np(tap.grads)
