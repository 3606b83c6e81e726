"""Dispatch of every kernel call by the device of its tensors.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the CUDA kernel, or the call raises.  There is no switch and no fallback:
on the card the main path runs the kernels and nothing else.

While a profiler records, the wrappers count (`repro_torch.trace`) each
launch of a CUDA kernel, `kernels.<kernel>.launches` (never a call of the
plain version), and the pairs handed to `m2l_separable` on either path,
`kernels.m2l_separable.pairs`.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.kernels import gaussian_nbody as _nbody, m2l_pair, msp_update as _msp
from repro_torch.kernels import synaptic_input as _syn


def msp_update(x, refrac, calcium, syn_input, uniform, cfg):
    """Fused MSP phase 1.  cfg: repro_torch.core.msp.MSPConfig.
    Returns (x', refrac', spiked bool, calcium')."""
    k = _msp.constants(cfg)
    if x.device.type == "cpu":
        return _msp.msp_update_plain(x, refrac, calcium, syn_input, uniform, k)
    out = _msp.msp_update_cuda(x, refrac, calcium, syn_input, uniform, k)
    if x.shape[0]:
        trace.count("kernels.msp_update.launches", 1)
    return out


def m2l_separable(moms: torch.Tensor, herm: torch.Tensor, y: torch.Tensor,
                  p: int = 4) -> torch.Tensor:
    """Envelope-free separable M2L series.  (B, p^3), (B, p^3), (B, 3) -> (B,)."""
    trace.count("kernels.m2l_separable.pairs", moms.shape[0])
    if moms.device.type == "cpu":
        return m2l_pair.m2l_separable_plain(moms, herm, y, p)
    out = m2l_pair.m2l_separable_cuda(moms, herm, y, p)
    if moms.shape[0]:
        trace.count("kernels.m2l_separable.launches", 1)
    return out


def gaussian_nbody(targets: torch.Tensor, sources: torch.Tensor,
                   weights: torch.Tensor, delta: float) -> torch.Tensor:
    """u_i = sum_j w_j exp(-||t_i - s_j||^2/delta).  (N, 3), (M, 3), (M,) -> (N,)."""
    if targets.device.type == "cpu":
        return _nbody.gaussian_nbody_plain(targets, sources, weights, delta)
    out = _nbody.gaussian_nbody_cuda(targets, sources, weights, delta)
    if targets.shape[0]:
        trace.count("kernels.gaussian_nbody.launches", 1)
    return out


def synaptic_input(edges, spiked: torch.Tensor, sign: torch.Tensor | None = None) -> torch.Tensor:
    """(..., n) signed count of spiking presynaptic partners.  edges:
    repro_torch.core.synapses.SynapseState over (..., E) slots; spiked and
    sign (None = all +1): (..., n)."""
    if spiked.device.type == "cpu":
        # The plain version is the edge store's own; that module imports this one.
        from repro_torch.core import synapses
        return synapses.synaptic_input(edges, spiked, sign)
    # The kernel reads rows in place; the plain version takes any strides, so
    # a view (the distributed engine gathers spikes along dim 1) is copied
    # here once.
    out = _syn.synaptic_input_cuda(*(t.contiguous() for t in (*edges, spiked)),
                                   None if sign is None else sign.contiguous())
    if edges.valid.numel() and spiked.shape[-1]:
        trace.count("kernels.synaptic_input.launches", 1)
    return out
