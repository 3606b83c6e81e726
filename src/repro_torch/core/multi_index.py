"""Multi-index tables and per-dimension Hermite polynomials (port of
`repro/core/multi_index.py`).

3D multi-indices ``alpha = (n1, n2, n3)`` with ``0 <= n_i < p``; the paper's
cut-off p = 4 gives 64 coefficients.  The tables are host numpy, computed
once; the feature maps work on tensors of any device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# Paper cut-off: alpha = beta = (3,3,3)  ->  p = 4 terms per dimension.
DEFAULT_ORDER = 4


@functools.lru_cache(maxsize=None)
def multi_indices(p: int = DEFAULT_ORDER) -> np.ndarray:
    """All 3D multi-indices with 0 <= n_i < p, shape (p**3, 3), C-order."""
    idx = np.indices((p, p, p)).reshape(3, -1).T
    return np.ascontiguousarray(idx.astype(np.int32))


@functools.lru_cache(maxsize=None)
def factorial_table(p: int = DEFAULT_ORDER) -> np.ndarray:
    """n! for n = 0..p-1."""
    out = np.ones((p,), dtype=np.float64)
    for n in range(1, p):
        out[n] = out[n - 1] * n
    return out


@functools.lru_cache(maxsize=None)
def multi_factorial(p: int = DEFAULT_ORDER) -> np.ndarray:
    """alpha! = n1! * n2! * n3! for every multi-index, shape (p**3,)."""
    fac = factorial_table(p)
    mi = multi_indices(p)
    return fac[mi[:, 0]] * fac[mi[:, 1]] * fac[mi[:, 2]]


@functools.lru_cache(maxsize=None)
def multi_abs(p: int = DEFAULT_ORDER) -> np.ndarray:
    """|alpha| = n1 + n2 + n3, shape (p**3,)."""
    return multi_indices(p).sum(axis=1)


@functools.lru_cache(maxsize=None)
def sign_table(p: int = DEFAULT_ORDER) -> np.ndarray:
    """(-1)^{|alpha|}, shape (p**3,)."""
    return np.where(multi_abs(p) % 2 == 0, 1.0, -1.0)


@functools.lru_cache(maxsize=None)
def m2l_index_map(p: int = DEFAULT_ORDER) -> np.ndarray:
    """For every (beta, alpha) pair, the flat index of alpha + beta in the
    order-(2p-1) multi-index enumeration: the gather that builds the dense
    (k, k) Hermite->Taylor translation matrix.  Shape (p**3, p**3), int32."""
    big_p = 2 * p - 1
    idx = multi_indices(p).astype(np.int64)
    comb = idx[:, None, :] + idx[None, :, :]                 # (beta, alpha, 3)
    flat = (comb[..., 0] * big_p + comb[..., 1]) * big_p + comb[..., 2]
    return flat.astype(np.int32)


def _products(per_dim: torch.Tensor, p: int) -> torch.Tensor:
    """prod_d f_{n_d}(x_d) for every multi-index from per-dimension factors
    (..., 3, p) -> (..., p**3)."""
    mi = torch.as_tensor(multi_indices(p), dtype=torch.long, device=per_dim.device)
    return per_dim[..., 0, mi[:, 0]] * per_dim[..., 1, mi[:, 1]] * per_dim[..., 2, mi[:, 2]]


def monomials(x: torch.Tensor, p: int = DEFAULT_ORDER) -> torch.Tensor:
    """x^alpha = x1^n1 * x2^n2 * x3^n3 for every multi-index (paper Eq. 5).

    x: (..., 3) -> (..., p**3).
    """
    steps = [torch.ones_like(x)]
    for _ in range(p - 1):
        steps.append(steps[-1] * x)
    return _products(torch.stack(steps, dim=-1), p)


def _per_dim_hermite_poly(x: torch.Tensor, p: int) -> torch.Tensor:
    """Physicists' Hermite polynomials H_n(t), n = 0..p-1, by the recurrence
    H_0 = 1, H_1 = 2t, H_{n+1} = 2t H_n - 2n H_{n-1}.  (..., 3) -> (..., 3, p).
    """
    steps = [torch.ones_like(x)]
    if p > 1:
        steps.append(2.0 * x)
    for n in range(1, p - 1):
        steps.append(2.0 * x * steps[-1] - 2.0 * n * steps[-2])
    return torch.stack(steps, dim=-1)


def _per_dim_hermite(x: torch.Tensor, p: int) -> torch.Tensor:
    """Hermite functions h_n(t) = (-1)^n d^n/dt^n exp(-t^2), n = 0..p-1, by
    h_0 = exp(-t^2), h_1 = 2t h_0, h_{n+1} = 2t h_n - 2n h_{n-1}.
    (..., 3) -> (..., 3, p)."""
    steps = [torch.exp(-x * x)]
    if p > 1:
        steps.append(2.0 * x * steps[0])
    for n in range(1, p - 1):
        steps.append(2.0 * x * steps[-1] - 2.0 * n * steps[-2])
    return torch.stack(steps, dim=-1)


def hermites(x: torch.Tensor, p: int = DEFAULT_ORDER) -> torch.Tensor:
    """h_alpha(x) = h_n1(x1) h_n2(x2) h_n3(x3).  (..., 3) -> (..., p**3)."""
    return _products(_per_dim_hermite(x, p), p)


def hermite_polys(x: torch.Tensor, p: int = DEFAULT_ORDER) -> torch.Tensor:
    """H_alpha(x) = prod_d H_{n_d}(x_d), so h_alpha(x) = exp(-||x||^2) H_alpha(x).
    (..., 3) -> (..., p**3)."""
    return _products(_per_dim_hermite_poly(x, p), p)


def hermite_big(x: torch.Tensor, p: int = DEFAULT_ORDER) -> torch.Tensor:
    """h_gamma(x) for gamma up to order 2(p-1), in the order-(2p-1)
    enumeration: what the dense M2L translation gathers from.
    (..., 3) -> (..., (2p-1)**3)."""
    return hermites(x, 2 * p - 1)


def hermite_polys_big(x: torch.Tensor, p: int = DEFAULT_ORDER) -> torch.Tensor:
    """H_gamma(x) (no envelope) for gamma up to order 2(p-1), in the
    order-(2p-1) enumeration.  (..., 3) -> (..., (2p-1)**3)."""
    return hermite_polys(x, 2 * p - 1)
