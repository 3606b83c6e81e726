"""Separable M2L pair series: CUDA kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/m2l_pair.py::m2l_separable`
(body `_kernel`, helpers `_take_dim`/`_stack_dim`); the oracle is
`repro/kernels/ref.py::m2l_separable`.  For a batch of (source box, target
box) pairs,

    series = sum_{alpha,beta} sign_alpha A_alpha (moms_beta / beta!)
             * prod_d H_{alpha_d + beta_d}(y_d)

with y the scaled centre offset; the exp(-||y||^2) envelope is applied by
the caller in log space.  The translation factorises per dimension, so each
pair needs three 4x4 Hankel matrices G_d[a, b] = H_{a+b}(y_d) and three mode
products of the 4x4x4 moment tensor.

Bound on the H100: bandwidth.  A pair reads 64 + 64 + 3 floats and writes
one: 528 B for about 1.8 kFLOP, some 3.4 FLOP/B against a float32 ridge of
about 20 FLOP/B (67 TFLOP/s over 3.35 TB/s).  Design (csrc/m2l_pair.cu):
one pair per thread, 64 pairs a block staged through shared memory with
coalesced 16-byte loads, the moment tensor and H_0..H_6 in registers, the
mode products unrolled.  The 1/beta! and sign tables are folded in by the
kernel from compile-time constants, not by the wrapper, so the wrapper makes
no extra pass over the (B, 64) inputs.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import multi_index as mi
from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/m2l_pair.cu"
REPLACES = "src/repro/kernels/m2l_pair.py:114"
P = 4                      # the kernel is compiled for p = 4 (k = 64)


def m2l_separable_plain(moms: torch.Tensor, herm: torch.Tensor, y: torch.Tensor,
                        p: int = P) -> torch.Tensor:
    """The plain PyTorch version.  moms/herm (B, p^3), y (B, 3) -> (B,)."""
    big_p = 2 * p - 1
    hd = mi._per_dim_hermite_poly(y, big_p)                 # (B, 3, 2p-1)
    a = np.arange(p)
    hank = torch.as_tensor(a[:, None] + a[None, :], device=y.device)
    g = hd[..., hank]                                       # (B, 3, p, p)
    dev, dt = moms.device, moms.dtype
    sign = torch.as_tensor(mi.sign_table(p), dtype=dt, device=dev)
    fact = torch.as_tensor(mi.multi_factorial(p), dtype=dt, device=dev)
    t = (moms / fact).reshape(moms.shape[:-1] + (p, p, p))
    t = torch.einsum('...ab,...bcd->...acd', g[..., 0, :, :], t)
    t = torch.einsum('...ab,...cbd->...cad', g[..., 1, :, :], t)
    t = torch.einsum('...ab,...cdb->...cda', g[..., 2, :, :], t)
    asign = (herm * sign).reshape(herm.shape[:-1] + (p, p, p))
    return (asign * t).sum(dim=(-3, -2, -1))


def m2l_separable_cuda(moms: torch.Tensor, herm: torch.Tensor,
                       y: torch.Tensor, p: int = P) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Same output as
    `m2l_separable_plain`."""
    if p != P:
        raise ValueError(f"m2l_separable kernel is built for p = {P}, got {p}")
    b = moms.shape[0]
    for t, cols, align, name in ((moms, P ** 3, 16, "moms"),
                                 (herm, P ** 3, 16, "herm"), (y, 3, 4, "y")):
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or t.shape != (b, cols) or not t.is_contiguous() \
                or t.data_ptr() % align:
            raise ValueError(
                f"m2l_separable: {name} must be a contiguous, {align}-byte "
                f"aligned CUDA float32 tensor of shape ({b}, {cols}), got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((b,), dtype=torch.float32, device=moms.device)
    if b:
        p_ = lambda t: ctypes.c_void_p(t.data_ptr())
        err = build.library().m2l_separable_launch(
            p_(moms), p_(herm), p_(y), p_(out), b,
            ctypes.c_void_p(torch.cuda.current_stream(moms.device).cuda_stream))
        build.check(err, "m2l_separable")
    return out
