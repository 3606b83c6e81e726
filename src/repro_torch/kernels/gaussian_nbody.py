"""Direct Gaussian n-body sum: CUDA kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/gaussian_nbody.py::
gaussian_nbody` (body `_kernel`); the oracle is
`repro/kernels/ref.py::gaussian_nbody`:

    u_i = sum_j w_j exp(-||t_i - s_j||^2 / delta)

targets (N, 3), sources (M, 3), weights (M,) float32 -> (N,) float32.

Squared distances use the oracle's difference form sum_d (t_d - s_d)^2,
not the TPU kernel's |t|^2 + |s|^2 - 2 t.s: that form exists to put a
K = 8 product on the MXU, would need TF32 tensor cores here, and cancels
badly at coordinates of a few thousand micrometres.

The exponential.  The kernel calls neither `expf` nor `__expf` but
`exp2f(d2 * scale)` with scale = -log2(e)/delta rounded once on the host.
That is what `__expf` does inside (a multiply by log2(e), then the SFU's
`ex2`), with the two multiplies folded into one, so the argument carries
the same single rounding as the oracle's `-d2/delta`.  `expf` would add a range reduction of
about five FP32 instructions per pair to buy accuracy that only the
terms below e^-20 or so would see, and those do not move a sum whose
largest terms are O(1).

Accuracy.  Each thread sums a tile of 1024 sources into a float32 partial
and adds the partial to its running total (the TPU kernel's per-block
`part` added to `o_ref`): two levels of about sqrt(M) terms each at
M = 2^20, instead of one chain of M terms, whose rounding error grows
with M.  Tests hold the kernel to rtol 2e-5, atol 1e-6 against the
plain version and, at M = 2^20, against a float64 sum.

Bound on the H100: operations.  Per pair the kernel issues 3 FADD, 1 FMUL
and 2 FFMA for d2, 1 FMUL for the argument, 1 SFU `ex2` and 1 FFMA for
the weighted sum: 8 FP32 instructions plus one `ex2`.  Each FP32
instruction, FADD and FMUL as much as FFMA, takes one lane slot: 128 a
clock per SM, 132 SMs x 128 x 1.98 GHz = 3.35e13/s (the 67 TFLOP/s peak
counts an FFMA as 2 FLOP).  At N = M = 2^20 (1.1e12 pairs) the FP32
instructions take 0.263 s and the `ex2`s, at 16 a clock per SM
(4.18e12/s), take 0.263 s too: both pipes sit at the same floor, so a
faster kernel has to cut FP32 instructions as well as SFU work (for
example, coordinates pre-scaled by sqrt(-scale) drop the argument's
FMUL).  The call needs
32 MB from device memory (inputs once, output once), 0.01 ms at
3.35 TB/s; every block re-reads the 16 MB of sources, which stay in the
50 MB L2.  Design: one
target per thread, 256 threads a block, sources staged through 16 KB of
shared memory as float4 (x, y, z, w) and read back as broadcasts.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/gaussian_nbody.cu"
REPLACES = "src/repro/kernels/gaussian_nbody.py:93"
PLAIN_CHUNK_PAIRS = 1 << 26     # (targets x sources) per chunk of the plain version


def gaussian_nbody_plain(targets: torch.Tensor, sources: torch.Tensor,
                         weights: torch.Tensor, delta: float) -> torch.Tensor:
    """The plain PyTorch version: the oracle's difference form, chunked over
    targets so that no (N, M) temporary exceeds PLAIN_CHUNK_PAIRS elements
    and no (N, M, 3) one is built.  Works in the inputs' dtype (float64 for
    a reference sum)."""
    n, m = targets.shape[0], sources.shape[0]
    out = torch.empty((n,), dtype=targets.dtype, device=targets.device)
    step = max(1, PLAIN_CHUNK_PAIRS // max(m, 1))
    for a in range(0, n, step):
        t = targets[a:a + step]
        d2 = (t[:, None, 0] - sources[None, :, 0]) ** 2
        d2 += (t[:, None, 1] - sources[None, :, 1]) ** 2
        d2 += (t[:, None, 2] - sources[None, :, 2]) ** 2
        out[a:a + step] = torch.exp(-d2 / delta) @ weights
    return out


def scale_of(delta: float) -> np.float32:
    """The kernel's exp2 argument scale, -log2(e)/delta, rounded once."""
    return np.float32(-1.0 / (math.log(2.0) * delta))


def gaussian_nbody_cuda(targets: torch.Tensor, sources: torch.Tensor,
                        weights: torch.Tensor, delta: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Same output as
    `gaussian_nbody_plain`."""
    n, m = targets.shape[0], sources.shape[0]
    for t, shape, name in ((targets, (n, 3), "targets"), (sources, (m, 3), "sources"),
                           (weights, (m,), "weights")):
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"gaussian_nbody: {name} must be a contiguous CUDA float32 tensor "
                f"of shape {shape}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((n,), dtype=torch.float32, device=targets.device)
    if n:
        p = lambda t: ctypes.c_void_p(t.data_ptr())
        err = build.library().gaussian_nbody_launch(
            p(targets), p(sources), p(weights), p(out), n, m, float(scale_of(delta)),  # audit: ok
            ctypes.c_void_p(torch.cuda.current_stream(targets.device).cuda_stream))
        build.check(err, "gaussian_nbody")
    return out
