"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
package's: the router's choices, the integer dispatch (exact), and the
layer's output, with dropped tokens at capacity_factor 1.25."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JE
from repro_torch.models import moe as TE

from _torch_lm import assert_ulps, bf16, f32, load, no_grad, reduced  # noqa: F401 (a fixture)

# Forward checks: no autograd graph (the parameters are trainable).
pytestmark = pytest.mark.usefixtures("no_grad")


def _moe(name, capacity_factor):
    cfg = reduced(name, capacity_factor)
    jp = JE.moe_init(jax.random.key(0), cfg)
    return cfg, jp, load(TE.MoE(cfg, None, "cpu"), jp)


def _loop_dispatch(expert, e, cap):
    """The dispatch rule, one assignment at a time in (token, choice) order."""
    b, s, k = expert.shape
    rank = np.zeros((b, s * k), np.int64)
    for r in range(b):
        count = np.zeros(e, np.int64)
        for i, ex in enumerate(expert[r].reshape(-1)):
            rank[r, i] = count[ex]
            count[ex] += 1
    keep = rank < cap
    return rank, keep, np.where(keep, expert.reshape(b, -1) * cap + rank, e * cap)


def _inputs(cfg, b, s, skew, seed):
    """Rows near one shared direction (skew) crowd a few experts, so at
    capacity_factor 1.25 some assignments overflow."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, 1, cfg.d_model))
    return bf16(skew * base + rng.normal(size=(b, s, cfg.d_model)))


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("capacity_factor,skew", [(1.25, 3.0), (8.0, 0.0)])
def test_moe_routing_dispatch_and_output(name, capacity_factor, skew):
    cfg, jp, tp = _moe(name, capacity_factor)
    b, s = 2, 24
    xj, xt = _inputs(cfg, b, s, skew, seed=int(skew))
    cap = TE._capacity(s, cfg)
    assert cap == JE._capacity(s, cfg)

    # router: JAX's probabilities and top-k, the port's at float32 tolerance;
    # the choices equal wherever the k-th and (k+1)-th probabilities differ
    # by more than that tolerance (no tie within rounding)
    probs_j = np.asarray(jax.nn.softmax(xj.astype(jnp.float32) @ jp["router"], axis=-1))
    gate_j, expert_j = (np.asarray(a) for a in jax.lax.top_k(probs_j, cfg.top_k))
    gate_t, expert_t, probs_t = TE.route(tp, xt, cfg)
    np.testing.assert_allclose(probs_t.numpy(), probs_j, rtol=1e-5, atol=1e-7)
    srt = np.sort(probs_j, axis=-1)[..., ::-1]
    clear = (srt[..., cfg.top_k - 1] - srt[..., cfg.top_k]) > 1e-5
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(expert_t.numpy()[clear], expert_j[clear])
    np.testing.assert_allclose(gate_t.numpy(), gate_j / gate_j.sum(-1, keepdims=True),
                               rtol=1e-5, atol=1e-6)

    # integer dispatch of JAX's choices: exact, kept slots written once
    dsp = TE.dispatch(torch.from_numpy(expert_j.astype(np.int64)), cfg.num_experts, cap)
    rank, keep, slot = _loop_dispatch(expert_j, cfg.num_experts, cap)
    for got, want in zip(dsp, (rank, keep, slot), strict=True):
        np.testing.assert_array_equal(got.numpy(), want)
    for r in range(b):
        kept = dsp.slot[r][dsp.keep[r]]
        assert kept.unique().numel() == kept.numel()
    if capacity_factor == 1.25:
        assert (~keep).sum() > 0           # tokens were dropped
    else:
        assert keep.all()

    # the layer: JAX's eager ops, bf16 within two ulps of each row's largest
    # output (gates and the routed sum in bf16), where the choices agree
    out_j = f32(JE.moe_apply(jp, xj, cfg))
    out_t = f32(TE.moe_apply(tp, xt, cfg))
    rows = np.all(expert_t.numpy() == expert_j, axis=-1)
    assert_ulps(out_t[rows], out_j[rows], ulps=2, equal_frac=0.9)


def test_moe_zero_input_gives_zero():
    cfg, jp, tp = _moe("deepseek-v2-lite-16b", None)
    y = TE.moe_apply(tp, torch.zeros((2, 16, cfg.d_model), dtype=torch.bfloat16), cfg)
    assert y.shape == (2, 16, cfg.d_model) and not y.float().abs().max()


def test_swiglu():
    cfg = reduced("yi-6b")
    jp = JE.swiglu_init(jax.random.key(3), cfg.d_model, cfg.d_ff)
    tp = load(TE.SwiGLU(cfg.d_model, cfg.d_ff, None, "cpu"), jp)
    xj, xt = bf16(np.random.default_rng(3).normal(size=(2, 16, cfg.d_model)))
    assert_ulps(TE.swiglu(tp, xt), JE.swiglu(jp, xj), equal_frac=0.99)


def test_topk_ties_take_the_lower_index():
    """jax.lax.top_k's rule on ties, which the stable sort keeps."""
    cfg = reduced("deepseek-v2-lite-16b")
    tp = TE.MoE(cfg, None, "cpu")
    tp.router.data.zero_()                 # every probability equal
    _, expert, _ = TE.route(tp, torch.ones((1, 3, cfg.d_model), dtype=torch.bfloat16), cfg)
    want = np.asarray(jax.lax.top_k(jnp.full((1, 3, cfg.num_experts), 0.125), cfg.top_k)[1])
    np.testing.assert_array_equal(expert.numpy(), want)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"])
def test_load_balancing_loss_matches_reference(name):
    """The Switch aux loss on the same float32 router probabilities and
    top-k choices: within 1e-6 relative of the reference's (float32 means
    summed in another order)."""
    cfg = reduced(name)
    logits = np.random.default_rng(3).normal(size=(64, cfg.num_experts)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    idx = np.asarray(jax.lax.top_k(jnp.asarray(probs), cfg.top_k)[1])
    want = float(JE.load_balancing_loss(jnp.asarray(probs), jnp.asarray(idx), cfg.num_experts))
    got = float(TE.load_balancing_loss(torch.from_numpy(probs), torch.from_numpy(idx).long(),
                                       cfg.num_experts))
    assert abs(got - want) <= 1e-6 * abs(want)
