"""The port's AdamW (`repro_torch.optim.adamw`) against the JAX package's:
the four AdamW tests of `test_substrate.py` mirrored, `update` on the same
gradients, and the weight-decay mask on every leaf of the ten configs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import ARCH_NAMES
from repro import configs as jax_configs
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.optim import adamw


def test_adamw_converges_on_quadratic():
    cfg = adamw.OptConfig(peak_lr=0.1, warmup_steps=5, total_steps=300,
                          weight_decay=0.0, master_weights=True)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw.init(params, cfg)
    for _ in range(300):
        params, state = adamw.update({"w": 2 * (params["w"] - target)}, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


def test_schedule_shape():
    cfg = adamw.OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(adamw.schedule(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1e-3) < 1e-9
    assert lrs[100] == pytest.approx(1e-4, rel=1e-3)
    assert all(a >= b - 1e-12 for a, b in zip(lrs[10:], lrs[11:]))  # decay
    want = [float(jadamw.schedule(jadamw.OptConfig(peak_lr=1e-3, warmup_steps=10,
                                                   total_steps=100, min_lr_ratio=0.1),
                                  jnp.asarray(s))) for s in range(101)]
    assert lrs == pytest.approx(want, rel=3e-7)      # an ulp of float32 cos near pi


def test_grad_clipping():
    cfg = adamw.OptConfig(grad_clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = adamw.init(params, cfg)
    new_params, _ = adamw.update({"w": torch.full((4,), 1e6)}, state, params, cfg)
    # effective per-step move bounded by lr (clipped direction, |m/sqrt(v)|<=1)
    assert float(new_params["w"].abs().max()) < 10 * cfg.peak_lr


def test_bf16_master_weights_accumulate_small_updates():
    cfg = adamw.OptConfig(peak_lr=1e-4, warmup_steps=0, total_steps=1000,
                          weight_decay=0.0, master_weights=True)
    params = {"w": torch.ones(8, dtype=torch.bfloat16) * 1000.0}
    state = adamw.init(params, cfg)
    for _ in range(10):
        params, state = adamw.update({"w": torch.ones(8, dtype=torch.bfloat16)}, state,
                                     params, cfg)
    # master moved even though each bf16 step underflows the mantissa
    assert float(state.master["w"][0]) < 1000.0
    assert float(params["w"][0]) == 1000.0


@pytest.mark.parametrize("master", [True, False])
def test_update_matches_reference(master):
    """Three updates of a bf16 tree (a weight, a norm scale, a bias) from the
    same gradients: params, mu, nu, master and count within 1e-6 relative
    (the same float32 arithmetic; an ulp of sqrt or pow between XLA and
    torch)."""
    rng = np.random.default_rng(0)
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, master_weights=master)
    shapes = {"layers": {"attn": {"wq": (2, 8, 8), "bq": (2, 8)}, "ln1": {"scale": (2, 8)}},
              "final_norm": {"scale": (8,)}, "embed": {"table": (16, 8)}}
    tree = lambda scale: jax.tree.map(
        lambda s: np.asarray(rng.normal(scale=scale, size=s), np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    p0 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree(1.0))
    grads = [jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree(0.3)) for _ in range(3)]
    jcfg, tcfg = jadamw.OptConfig(**cfg), adamw.OptConfig(**cfg)

    jp, js = p0, jadamw.init(p0, jcfg)
    named = lambda t: {k: convert._to_torch(v) for k, v in
                       convert._flat_named(jax.tree.map(np.asarray, t)).items()}
    tp = named(p0)
    ts = adamw.init(tp, tcfg)
    with jax.disable_jit():
        for g in grads:
            jp, js = jadamw.update(g, js, jp, jcfg)
            tp, ts = adamw.update(named(g), ts, tp, tcfg)
    assert int(ts.count) == int(js.count) == 3
    pairs = [(tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)] + ([(ts.master, js.master)] if master
                                                           else [])
    for got, want in pairs:
        want = convert._flat_named(jax.tree.map(np.asarray, want))
        assert set(got) == set(want)
        for k, w in want.items():
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(got[k].float().numpy(), w, rtol=1e-6, atol=1e-9,
                                       err_msg=k)
    assert ts.master is None if not master else ts.master is not None


def test_global_norm_in_reference_leaf_order():
    """The per-leaf sums are added in the reference's flattening order; the
    norm equals JAX's within 1e-5 (float32 sums of up to 16384 squares,
    each leaf's in another order)."""
    cfg = jax_configs.get("deepseek-v2-lite-16b").reduced()
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), cfg))
    named = {k: convert._to_torch(v) for k, v in convert._flat_named(params).items()}
    with jax.disable_jit():
        want = float(jadamw.global_norm(params))
    assert float(adamw.global_norm(named)) == pytest.approx(want, rel=1e-5)
    want_order = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        if keys[0] in ("layers", "dense_prefix", "dense_inter"):
            want_order += [".".join([keys[0], str(i)] + keys[1:]) for i in range(leaf.shape[0])]
        else:
            want_order.append(".".join(keys))
    assert adamw.leaf_order(named) == want_order


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decay_mask_equals_reference(name):
    """Every leaf of the config: the port's rule on the parameter name gives
    the reference's `_decay_mask` on its tree path (`bq`, `bk`, `bv` are
    decayed; `conv_b`, `scale`, `a_log`, `d_skip`, `dt_bias` are not)."""
    cfg = jax_configs.get(name).reduced()
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), cfg))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = {".".join(p.key for p in path): jadamw._decay_mask(path) for path, _ in flat}
    for path, leaf in flat:
        name_ = ".".join(p.key for p in path)
        if path[0].key in ("layers", "dense_prefix", "dense_inter"):
            name_ = ".".join([path[0].key, "0"] + [p.key for p in path[1:]])
        assert adamw._decay_mask(name_) == want[".".join(p.key for p in path)], name_
    undecayed = {k.split(".")[-1] for k, v in want.items() if not v}
    assert undecayed <= {"scale", "a_log", "d_skip", "dt_bias", "conv_b", "b"}
    for leaf in ("bq", "bk", "bv", "conv_w", "router", "table", "wq"):
        assert adamw._decay_mask("layers.0.attn." + leaf)
