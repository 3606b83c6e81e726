"""`CounterNoise` (`repro_torch/core/streams.py`): every draw a pure function
of (seed, step, kind, level, logical index[, column]).

Prefix stability is the property the padded subdomains need: a draw at
idx[:m] equals the first m values of the draw at idx, for every draw kind.
The draws are deterministic by seed and the same on repeated calls, distinct
streams differ, and the Gumbel-max choice over equal log weights is uniform
(chi-square over 8 columns and 10^5 rows, p > 1e-3).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import streams
from repro_torch.core.streams import CounterNoise

CPU = torch.device("cpu")


def _draws(noise, idx, step=3):
    """Every draw kind at the index set idx (the second axis fixed)."""
    return {
        "spike": noise.spike_uniform(step, idx),
        "delete0": noise.delete_bits(step, 0, idx),
        "delete1": noise.delete_bits(step, 1, idx),
        "descent": noise.descent_gumbel(step, 2, idx),
        "leaf": noise.leaf_gumbel(step, idx, 7),
        "direct": noise.direct_gumbel(step, idx, 40),
        "conflict": noise.conflict_bits(step, idx),
    }


@pytest.mark.parametrize("m", [1, 17, 48])
def test_every_draw_kind_is_prefix_stable(m):
    noise = CounterNoise(12345, CPU)
    idx = torch.arange(64, dtype=torch.int64)
    full, head = _draws(noise, idx), _draws(noise, idx[:m])
    for name in full:
        assert torch.equal(head[name], full[name][:m]), name


def test_draws_depend_on_the_logical_index_not_the_position():
    """An index set in another order, or a gather of it, draws the same
    values per index: the FMM descent keys by occupied box ids."""
    noise = CounterNoise(7, CPU)
    idx = torch.tensor([5, 900, 3, 77, 12], dtype=torch.int64)
    perm = torch.tensor([3, 0, 4, 1, 2])
    a, b = _draws(noise, idx), _draws(noise, idx[perm])
    for name in a:
        assert torch.equal(a[name][perm], b[name]), name


def test_deterministic_by_seed_and_repeatable():
    idx = torch.arange(256, dtype=torch.int64)
    a = _draws(CounterNoise(99, CPU), idx)
    b = _draws(CounterNoise(99, CPU), idx)
    c = _draws(CounterNoise(100, CPU), idx)
    noise = CounterNoise(99, CPU)
    again = [_draws(noise, idx) for _ in range(2)]
    for name in a:
        assert torch.equal(a[name], b[name]), name
        assert torch.equal(again[0][name], again[1][name]), name
        assert not torch.equal(a[name], c[name]), name
    # another step, level, side or column axis is another stream
    assert not torch.equal(noise.spike_uniform(3, idx), noise.spike_uniform(4, idx))
    assert not torch.equal(noise.descent_gumbel(3, 2, idx), noise.descent_gumbel(3, 3, idx))
    assert not torch.equal(noise.delete_bits(3, 0, idx), noise.delete_bits(3, 1, idx))
    g = noise.leaf_gumbel(3, idx, 8)
    assert not torch.equal(g[:, 0], g[:, 1])


def test_value_ranges_and_dtypes():
    noise = CounterNoise(1, CPU)
    idx = torch.arange(10_000, dtype=torch.int64)
    u = noise.spike_uniform(0, idx)
    bits = noise.conflict_bits(0, idx)
    g = noise.leaf_gumbel(0, idx[:100], 16)
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # 23 mantissa bits: every uniform is a multiple of 2^-23
    assert torch.equal(u * 2**23, torch.floor(u * 2**23))
    assert bits.dtype == torch.int64 and int(bits.min()) >= 0 and int(bits.max()) < 2**32
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    assert abs(float(u.mean()) - 0.5) < 0.02


def test_batched_spike_uniforms_equal_per_stream_draws():
    """The service's one-pass draw of K streams at K steps."""
    rows = torch.arange(50, dtype=torch.int64)
    noises = [CounterNoise(s, CPU) for s in (0, 5, 2**31 - 1, 2**40)]
    steps = np.array([0, 100, 7, 12345], np.int64)
    got = streams.spike_uniforms(noises, steps, rows)
    want = torch.stack([nz.spike_uniform(int(s), rows) for nz, s in zip(noises, steps)])
    assert torch.equal(got, want)


def test_gumbel_argmax_is_uniform_chi_square():
    """Equal log weights over 8 columns: the Gumbel-max choice of 10^5 rows
    is uniform (chi-square, 7 degrees of freedom, p > 1e-3)."""
    noise = CounterNoise(2024, CPU)
    rows = torch.arange(100_000, dtype=torch.int64)
    choice = torch.argmax(noise.descent_gumbel(5, 1, rows), dim=-1)
    counts = torch.bincount(choice, minlength=8).double()
    expected = rows.shape[0] / 8
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    # Survival function of chi-square with 7 degrees of freedom (odd k):
    # Q = erfc(sqrt(x/2)) + sqrt(2x/pi) e^(-x/2) (1 + x/3 + x^2/15).
    x = chi2
    p = math.erfc(math.sqrt(x / 2)) + math.sqrt(2 * x / math.pi) * math.exp(-x / 2) \
        * (1 + x / 3 + x * x / 15)
    assert p > 1e-3, (chi2, counts.tolist())


def test_no_int64_product_reaches_two_to_the_63():
    """The hash's products stay below 2^63 for every 32-bit input: the
    largest multiplier half times the largest word."""
    worst = (2**32 - 1) * 0xFFFF
    assert worst < 2**63
    # the key multiplier is odd and below 2^31, so idx * a stays below 2^63
    for seed in (0, 1, 2**62):
        a, b, c = CounterNoise(seed, CPU).key(streams.SPIKE, 10**9)
        assert a % 2 == 1 and a < 2**31 and 0 <= b < 2**32 and 0 <= c < 2**32
        assert (2**32 - 1) * a + b < 2**63


def test_rejects_negative_seed():
    with pytest.raises(ValueError):
        CounterNoise(-1, CPU)
