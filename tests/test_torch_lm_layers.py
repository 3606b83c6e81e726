"""The port's LM layers and attention against the JAX package's, from the
same seeded inputs and converted parameters: `repro_torch.models.layers`
and `repro_torch.models.attention` (flash, decode, GQA, MLA)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

from _torch_lm import assert_ulps, bf16, f32, load, no_grad, reduced  # noqa: F401 (a fixture)

# Forward checks: no autograd graph (the parameters are trainable).
pytestmark = pytest.mark.usefixtures("no_grad")


def test_rms_norm_rope_embed_unembed_silu():
    """Elementwise and row ops: within one bf16 ulp, 99.9 % equal."""
    rng = np.random.default_rng(0)
    xj, xt = bf16(rng.normal(size=(2, 24, 64)) * 3)
    sj, st = bf16(rng.normal(size=(64,)))
    assert_ulps(TL.rms_norm(xt, st, 1e-6), JL.rms_norm({"scale": sj}, xj, 1e-6))
    qj, qt = bf16(rng.normal(size=(2, 24, 4, 32)))
    pos = np.broadcast_to(np.arange(100, 124, dtype=np.int32), (2, 24)).copy()
    for theta in (10_000.0, 500_000.0):
        assert_ulps(TL.apply_rope(qt, torch.from_numpy(pos), theta),
                    JL.apply_rope(qj, jnp.asarray(pos), theta))
    np.testing.assert_array_equal(TL.rope_frequencies(64, 1e6).numpy(),
                                  np.asarray(JL.rope_frequencies(64, 1e6)))
    tj, tt = bf16(rng.normal(size=(256, 64)))
    toks = rng.integers(0, 256, (2, 24)).astype(np.int32)
    np.testing.assert_array_equal(f32(TL.embed(tt, torch.from_numpy(toks))),
                                  f32(JL.embed({"table": tj}, jnp.asarray(toks))))
    # float32 products: float32 rounding of the sums apart
    np.testing.assert_allclose(TL.unembed(tt, xt).numpy(),
                               np.asarray(JL.unembed({"table": tj}, xj)), rtol=1e-5, atol=1e-5)
    assert_ulps(TL.silu(xt), jax.nn.silu(xj))
    wj, wt = bf16(rng.normal(size=(64, 96)) / 8)
    bj, bt = bf16(rng.normal(size=(96,)))
    assert_ulps(TL.linear(xt, wt, bt), JL.linear({"w": wj, "b": bj}, xj), equal_frac=0.99)


def _naive(q, k, v, causal, q_offset=0):
    """Softmax attention in float64, whole rows at once."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    qr = q.reshape(b, t, kv, h // kv, d).astype(np.float64)
    sc = np.einsum('btkgd,bskd->bkgts', qr, k.astype(np.float64)) * d ** -0.5
    if causal:
        mask = (q_offset + np.arange(t))[:, None] >= np.arange(s)[None, :]
        sc = np.where(mask, sc, -1e30)
    w = np.exp(sc - sc.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum('bkgts,bskd->btkgd', w, v.astype(np.float64)).reshape(b, t, h, v.shape[-1])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset,chunks", [(0, (16, 16)), (0, (64, 64)), (32, (8, 32)),
                                             (0, (32, 8))])
def test_flash_attention_vs_jax_and_naive(causal, q_offset, chunks):
    """float32 inputs: against JAX's flash at 1e-5 and a float64 softmax at
    1e-4 (the reference test's bound); chunks that split the sequence."""
    rng = np.random.default_rng(q_offset + chunks[0])
    b, t, s, h, kv, d, dv = 2, 64, 64 + q_offset, 4, 2, 16, 24
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, dv)).astype(np.float32)
    got = TA.flash_attention(*map(torch.from_numpy, (q, k, v)), causal, q_offset, *chunks)
    want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, q_offset,
                              *chunks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _naive(q, k, v, causal, q_offset),
                               rtol=1e-4, atol=1e-5)


def test_flash_attention_bf16_and_chunk_check():
    rng = np.random.default_rng(1)
    qj, qt = bf16(rng.normal(size=(2, 48, 4, 16)))
    kj, kt = bf16(rng.normal(size=(2, 48, 1, 16)))
    vj, vt = bf16(rng.normal(size=(2, 48, 1, 16)))
    assert_ulps(TA.flash_attention(qt, kt, vt, True, 0, 16, 24),
                JA.flash_attention(qj, kj, vj, True, 0, 16, 24))
    with pytest.raises(ValueError, match="divide"):
        TA.flash_attention(qt, kt, vt, True, 0, 32, 16)


@pytest.mark.parametrize("cache_pos", [0, 17, 39])
def test_decode_attention(cache_pos):
    rng = np.random.default_rng(cache_pos)
    qj, qt = bf16(rng.normal(size=(2, 1, 6, 16)))
    kj, kt = bf16(rng.normal(size=(2, 40, 3, 16)))
    vj, vt = bf16(rng.normal(size=(2, 40, 3, 16)))
    assert_ulps(TA.decode_attention(qt, kt, vt, cache_pos),
                JA.decode_attention(qj, kj, vj, jnp.asarray(cache_pos, jnp.int32)))


def _layer(name):
    cfg = reduced(name)
    jp = JA.attention_init(jax.random.key(0), cfg)
    return cfg, jp, load(TA.attention_init(cfg, None, "cpu"), jp)


@pytest.mark.parametrize("name", ["yi-6b", "qwen2-0.5b", "qwen3-8b", "hubert-xlarge",
                                  "deepseek-v2-lite-16b"])
def test_attention_train_prefill_decode(name):
    """GQA (plain, qkv_bias, qk_norm, bidirectional) and MLA (expanded prefill,
    absorbed float32 decode): the same bf16 arithmetic as JAX's eager ops,
    within one bf16 ulp of each row's largest output (the attention weights'
    bf16 rounding flips now and then: 97 % equal); caches likewise."""
    rng = np.random.default_rng(2)
    cfg, jp, tp = _layer(name)
    b, s, extra = 2, 16, 3
    xj, xt = bf16(rng.normal(size=(b, s + extra, cfg.d_model)))
    assert_ulps(TA.attention_apply(tp, xt, cfg)[0], JA.attention_apply(jp, xj, cfg)[0],
                equal_frac=0.97)
    if not cfg.supports_decode:
        return
    cj = JA.attention_make_cache(cfg, b, s + extra)
    ct = TA.attention_make_cache(cfg, b, s + extra, "cpu")
    oj, cj = JA.attention_apply(jp, xj[:, :s], cfg, cj)
    ot, ct = TA.attention_apply(tp, xt[:, :s], cfg, ct)
    assert_ulps(ot, oj, equal_frac=0.97)
    for i in range(extra):
        pos = s + i
        oj, cj = JA.attention_apply(jp, xj[:, pos:pos + 1], cfg, cj, jnp.asarray(pos, jnp.int32))
        ot, ct = TA.attention_apply(tp, xt[:, pos:pos + 1], cfg, ct, pos)
        assert_ulps(ot, oj, ulps=2 if cfg.use_mla else 1, equal_frac=0.97)
    for key in cj:
        assert_ulps(ct[key], cj[key], equal_frac=0.99)
