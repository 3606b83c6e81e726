"""Fused MSP phase-1 neuron update: CUDA kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/msp_update.py::msp_update`
(body `_kernel`), whose oracle is `repro/kernels/ref.py::msp_update`.

Per neuron, with the spike draw `u`:

    x'      = x + (x0 - x)/tau_x + background + w_syn*syn
    spiked  = (u < x') & (refrac <= 0)
    refrac' = spiked ? refractory : max(refrac - 1, 0)
    ca'     = ca*(1 - tau_ca) + beta_ca*spiked

Rounding.  `u < x'` decides every spike, so x' must be bitwise what the JAX
engine computes.  Jitted on XLA:CPU, the reference does not compute what its
source says: XLA turns the division into a multiply by r = 1/tau_x
(float32) and contracts both products into fused multiply-adds:

    x'  = fma(w_syn, syn, fma(x0 - x, r, x) + background)
    ca' = fma(ca, 1 - tau_ca, beta_ca * spk)

Both hold bit for bit for the standalone jitted `ref.msp_update` and inside
the jitted `PlasticityEngine.simulate` scan body; the commands that show it
are `PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py -k
"msp_update or fma"`.  The CUDA kernel pins this pattern with `__fmaf_rn`
and is built with `nvcc --fmad=false`, so no other product is contracted.
The plain version emulates each fma exactly: the float32 product is exact
in float64, the float64 sum is made round-to-odd from its TwoSum error, and
the final rounding to float32 is then the correctly rounded fma.

Bound on the H100: bandwidth.  One thread per neuron reads 20 B (x, refrac,
ca, syn, u) and writes 13 B (x', refrac', ca' and `spiked` as one byte):
33 B per neuron, about 10 us at n = 2^20 and 3.35 TB/s.  Design: one
thread per neuron, 256 threads a block, one coalesced load and store per
array; the model constants arrive as scalar arguments.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/msp_update.cu"
REPLACES = "src/repro/kernels/msp_update.py:64"


def constants(cfg) -> dict:
    """The kernel's scalar constants from an MSPConfig, rounded as XLA rounds
    them: Python-float expressions first, then one cast to float32."""
    f32 = np.float32
    return dict(x0=f32(cfg.x0), r=f32(1.0) / f32(cfg.tau_x),
                background=f32(cfg.background), w_syn=f32(cfg.w_syn),
                beta_ca=f32(cfg.beta_ca), one_minus_tau_ca=f32(1.0 - cfg.tau_ca),
                refractory=int(cfg.refractory))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 fma(a, b, c) from float64 arithmetic."""
    prod = a.double() * b.double()                 # exact: 24 + 24 bits
    cd = c.double()
    s = prod + cd
    bv = s - prod
    err = (prod - (s - bv)) + (cd - bv)            # TwoSum: s + err exact
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()                               # round-to-odd -> RN


def msp_update_plain(x, refrac, calcium, syn_input, uniform, k: dict):
    """The plain PyTorch version.  Returns (x', refrac', spiked bool, ca')."""
    c = {name: torch.tensor(v, device=x.device) for name, v in k.items()}
    x_new = fma_f32(c["w_syn"], syn_input, fma_f32(c["x0"] - x, c["r"], x)
                    + c["background"])
    spiked = (uniform < x_new) & (refrac <= 0)
    refrac_new = torch.where(spiked, c["refractory"].to(refrac.dtype),
                             torch.clamp(refrac - 1, min=0))
    ca_new = fma_f32(calcium, c["one_minus_tau_ca"],
                     c["beta_ca"] * spiked.to(torch.float32))
    return x_new, refrac_new, spiked, ca_new


def _check(t: torch.Tensor, dtype, n: int, name: str):
    if t.device.type != "cuda" or t.dtype != dtype or t.shape != (n,) \
            or not t.is_contiguous():
        raise ValueError(f"msp_update: {name} must be a contiguous CUDA {dtype} "
                         f"tensor of shape ({n},), got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def msp_update_cuda(x, refrac, calcium, syn_input, uniform, k: dict):
    """Launch the CUDA kernel on the current stream.  Same outputs as
    `msp_update_plain`."""
    n = x.shape[0]
    for t, dt, name in ((x, torch.float32, "x"), (refrac, torch.int32, "refrac"),
                        (calcium, torch.float32, "calcium"),
                        (syn_input, torch.float32, "syn_input"),
                        (uniform, torch.float32, "uniform")):
        _check(t, dt, n, name)
    x_new = torch.empty_like(x)
    refrac_new = torch.empty_like(refrac)
    spiked = torch.empty((n,), dtype=torch.bool, device=x.device)
    ca_new = torch.empty_like(calcium)
    if n:
        fn = build.library().msp_update_launch
        p = lambda t: ctypes.c_void_p(t.data_ptr())
        err = fn(p(x), p(refrac), p(calcium), p(syn_input), p(uniform),
                 p(x_new), p(refrac_new), p(spiked), p(ca_new), n,
                 float(k["x0"]), float(k["r"]), float(k["background"]),  # audit: ok
                 float(k["w_syn"]), float(k["beta_ca"]),  # audit: ok (host constants)
                 float(k["one_minus_tau_ca"]), k["refractory"],  # audit: ok
                 ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
        build.check(err, "msp_update")
    return x_new, refrac_new, spiked, ca_new
