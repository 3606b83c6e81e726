"""The port's flash-attention backward (`repro_torch.models.attention`)
against `jax.vjp` of the reference's `flash_attention` (its custom VJP) on
the same numpy inputs: causal and bidirectional, q_offset, GQA groups and
MLA's Dq != Dv, in float32 and bf16; and a float64 `gradcheck`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as jflash
from repro_torch.models.attention import flash_attention

# (causal, q_offset, B, T, S, H, KV, Dq, Dv, chunk)
CASES = {
    "gqa-causal": (True, 0, 2, 64, 64, 4, 2, 16, 16, 16),
    "bidirectional": (False, 0, 2, 32, 32, 4, 4, 16, 16, 16),
    "q-offset": (True, 16, 1, 16, 32, 4, 1, 16, 16, 8),
    "mla-causal": (True, 0, 1, 32, 32, 4, 4, 24, 16, 16),
    "mla-bidirectional": (False, 0, 1, 32, 32, 4, 4, 24, 16, 8),
}
# max |port - reference| over max |reference|, per output and gradient:
# float32 runs do the same float32 arithmetic (sums in another order);
# bf16 runs round the same values to bf16 (one ulp is 2^-8 of a value's
# binade).
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(case, seed=0):
    causal, qoff, b, t, s, h, kv, dq, dv, _ = CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, t, h, dq), (b, s, kv, dq), (b, s, kv, dv), (b, t, h, dv))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_backward_matches_reference_vjp(case, dtype):
    causal, qoff, *_, chunk = CASES[case]
    q, k, v, do = _inputs(case)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    o_ref, vjp = jax.vjp(lambda q, k, v: jflash(q, k, v, causal, qoff, chunk, chunk),
                         *(jnp.asarray(a, jd) for a in (q, k, v)))
    want = [o_ref] + list(vjp(jnp.asarray(do, jd)))
    tq, tk, tv = (torch.tensor(a).to(td).requires_grad_() for a in (q, k, v))
    o = flash_attention(tq, tk, tv, causal, qoff, chunk, chunk)
    got = [o] + list(torch.autograd.grad(o, (tq, tk, tv), torch.tensor(do).to(td)))
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.dtype == td and tuple(g.shape) == w.shape, name
        g, w = g.detach().float().numpy(), np.asarray(w, np.float32)
        assert np.abs(g - w).max() <= TOL[dtype] * np.abs(w).max(), (name, np.abs(g - w).max())


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0), (True, 4)])
def test_flash_backward_gradcheck_float64(causal, q_offset):
    """In float64 the blocks accumulate in float64: the analytic backward
    against finite differences (gradcheck's default tolerances)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.normal(size=shape), dtype=torch.float64, requires_grad=True)
               for shape in ((1, 8, 2, 6), (1, 12, 1, 6), (1, 12, 1, 4)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, causal, q_offset, 4, 4), (q, k, v))


def test_flash_saves_no_score_sized_tensor():
    """The autograd graph holds q, k, v, o and the log-sum-exp, and nothing
    of size T x S."""
    t = 64
    q, k, v = (torch.randn(1, t, 2, 8, requires_grad=True) for _ in range(3))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x.numel()) or x,
                                                  lambda x: x):
        flash_attention(q, k, v, True, 0, 16, 16)
    assert saved and max(saved) == q.numel()
