"""The port's Mamba2 block (`repro_torch.models.mamba2`) against the JAX
package's: the chunked SSD scan (a length that is not a whole number of
chunks), the causal conv, prefill with its cache hand-off and single-token
decode; and the port's chunked scan against its own stepwise decode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as JB
from repro_torch.models import mamba2 as TB

from _torch_lm import assert_ulps, bf16, f32, load, no_grad, reduced  # noqa: F401 (a fixture)

# Forward checks: no autograd graph (the parameters are trainable).
pytestmark = pytest.mark.usefixtures("no_grad")


def _mixer(name):
    cfg = reduced(name)
    jp = JB.mamba2_init(jax.random.key(0), cfg)
    jp["a_log"] = jnp.linspace(-1.0, 1.0, jp["a_log"].shape[0], dtype=jnp.float32)
    jp["dt_bias"] = jnp.linspace(-2.0, 0.5, jp["dt_bias"].shape[0], dtype=jnp.float32)
    return cfg, jp, load(TB.Mamba2(cfg, None, "cpu"), jp)


@pytest.mark.parametrize("t,chunk", [(40, 16), (16, 16), (7, 32), (64, 8)])
def test_ssd_chunked_vs_jax(t, chunk):
    """float32 inputs: y and the final state at rtol 1e-4 (exp of the
    cumulative log decays differs from XLA's by an ulp)."""
    rng = np.random.default_rng(t)
    b, h, p, n = 2, 3, 8, 5
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, h)))).astype(np.float32)
    a_log = rng.normal(size=(h,)).astype(np.float32)
    bm = rng.normal(size=(b, t, n)).astype(np.float32)
    cm = rng.normal(size=(b, t, n)).astype(np.float32)
    d = rng.normal(size=(h,)).astype(np.float32)
    yj, sj = JB._ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bm, cm, d)), chunk)
    yt, st = TB._ssd_chunked(*map(torch.from_numpy, (x, dt, a_log, bm, cm, d)), chunk)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4, atol=1e-4)


def test_causal_conv_vs_jax():
    rng = np.random.default_rng(0)
    xj, xt = bf16(rng.normal(size=(2, 9, 12)))
    wj, wt = bf16(rng.normal(size=(4, 12)) / 2)
    bj, bt = bf16(rng.normal(size=(12,)))
    sj, st = bf16(rng.normal(size=(2, 3, 12)))
    assert_ulps(TB._causal_conv(xt, wt, bt), JB._causal_conv(xj, wj, bj), equal_frac=0.98)
    assert_ulps(TB._causal_conv(xt, wt, bt, st), JB._causal_conv(xj, wj, bj, sj),
                equal_frac=0.98)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "zamba2-7b"])
def test_mamba_prefill_and_decode_vs_jax(name):
    """bf16 outputs within 2 ulps of each row's largest (the scan's float32
    sums in another order), the float32 state at rtol 1e-3."""
    cfg, jp, tp = _mixer(name)
    b, s, extra = 2, 40, 3                  # 40 = one chunk of 32 and a ragged one
    xj, xt = bf16(np.random.default_rng(1).normal(size=(b, s + extra, cfg.d_model)))
    assert_ulps(TB.mamba2_apply(tp, xt, cfg)[0], JB.mamba2_apply(jp, xj, cfg)[0],
                ulps=2, equal_frac=0.9)
    cj, ct = JB.mamba2_make_cache(cfg, b), TB.mamba2_make_cache(cfg, b, "cpu")
    yj, cj = JB.mamba2_apply(jp, xj[:, :s], cfg, cj)
    yt, ct = TB.mamba2_apply(tp, xt[:, :s], cfg, ct)
    for i in range(extra + 1):
        assert_ulps(yt, yj, ulps=2, equal_frac=0.9)
        assert_ulps(ct["conv"], cj["conv"], equal_frac=0.98)
        np.testing.assert_allclose(ct["ssm"].numpy(), np.asarray(cj["ssm"]),
                                   rtol=1e-3, atol=1e-3 * float(np.abs(cj["ssm"]).max()))
        if i < extra:
            pos = s + i
            yj, cj = JB.mamba2_apply(jp, xj[:, pos:pos + 1], cfg, cj, jnp.asarray(pos))
            yt, ct = TB.mamba2_apply(tp, xt[:, pos:pos + 1], cfg, ct, pos)


def test_chunked_equals_stepwise():
    """The twin of the reference's test_mamba_chunked_equals_stepwise: the
    port's chunked scan against its own one-token decode recurrence, at the
    reference test's rtol = atol = 0.05."""
    cfg, _, tp = _mixer("mamba2-1.3b")
    b, t = 2, 24
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(b, t, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    y_full, _ = TB.mamba2_apply(tp, x, cfg)
    cache = TB.mamba2_make_cache(cfg, b, "cpu")
    ys = []
    for i in range(t):
        yi, cache = TB.mamba2_apply(tp, x[:, i:i + 1], cfg, cache, i)
        ys.append(yi)
    np.testing.assert_allclose(f32(y_full), f32(torch.cat(ys, dim=1)), rtol=0.05, atol=0.05)


def test_one_token_prefill_takes_the_decode_branch():
    """A one-token prompt with a cache is a decode step (cache given and
    T == 1), whatever cache_pos says, as in the reference."""
    cfg, jp, tp = _mixer("mamba2-1.3b")
    xj, xt = bf16(np.random.default_rng(3).normal(size=(2, 1, cfg.d_model)))
    yt, ct = TB.mamba2_apply(tp, xt, cfg, TB.mamba2_make_cache(cfg, 2, "cpu"))
    yd, cd = TB.mamba2_apply(tp, xt, cfg, TB.mamba2_make_cache(cfg, 2, "cpu"), 0)
    assert torch.equal(yt, yd) and torch.equal(ct["ssm"], cd["ssm"])
    yj, _ = JB.mamba2_apply(jp, xj, cfg, JB.mamba2_make_cache(cfg, 2))
    assert_ulps(yt, yj, ulps=2, equal_frac=0.9)
