"""Spike propagation: the CUDA kernel's wrapper.  The plain PyTorch version
is the body of `repro_torch.core.synapses.synaptic_input`, beside the edge
table it reads.

Replaces no TPU kernel: the JAX package's `synaptic_input`
(`src/repro/core/synapses.py`) is a plain `segment_sum`.  The kernel is
here because the plain chain over an ensemble's tables (a `nonzero` over
the flags, gathers of the live slots' ids, int64 row offsets, a second
`nonzero` over the spiking sources, `index_add_`) moves some 60 GB a step
at K = 16 x 2^26 slots, about 30 times what the function needs.

Bound on the H100: bytes.  One pass reads a byte of flags a slot, the
4-byte `src` of the 16-slot groups that hold a live slot, and `dst` only
for a spiking source; the spikes (as bits), the signs and the sums stay in
L2.  At K = 16, n = 2^20, 64 slots a neuron, the live slots in the lower
half of each table (32.5 M of 67 M) and 1.4 % of neurons spiking: 1.07 GB
of flags, some 2.2 GB of `src`, a few hundred MB of `dst`, about 3.5 GB,
1.05 ms at 3.35 TB/s.

Design: a first kernel packs the spikes to one bit a neuron; the second
walks the slots in table order, each block loading its table's bits into
shared memory (n/8 bytes, at most 227 KB: beyond that it reads them from
device memory), each thread groups of 16 slots, two a round: flags first as
one 16-byte load, `src` only where a flag is set, `dst` and one float
atomic (a RED) only for a spiking source.  At the cells' shape the pass
takes some 1.8 ms; what it adds to streaming the flags and ids (1.15 ms)
is mostly the spiking slots' random `dst` reads (PERF.md §6).  Every term
is +1 or -1, and a float32 sum of integers below 2^24 is exact in any
order, so the output equals the plain version's bit for bit.  Slot indices
are 64-bit; a ragged or misaligned slot range (one rank's part of a table)
takes a scalar path at its ends.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/synaptic_input.cu"
REPLACES = None


def _check(t: torch.Tensor, dtype, shape, name: str, device):
    if t.device != device or t.dtype != dtype or t.shape != shape or not t.is_contiguous():
        raise ValueError(f"synaptic_input: {name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def synaptic_input_cuda(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                        spiked: torch.Tensor, sign: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernels on the current stream.  src, dst (int32), valid
    (bool): (..., E) edge tables; spiked (bool), sign (float32 or None):
    (..., n) with the tables' leading axes.  Returns the (..., n) float32
    signed count of spiking presynaptic partners."""
    device = spiked.device
    if device.type != "cuda" or spiked.dim() < 1 or valid.dim() != spiked.dim():
        raise ValueError(f"synaptic_input: spiked must be a CUDA tensor with the edge "
                         f"tables' leading axes, got {tuple(spiked.shape)} on {device} "
                         f"against tables {tuple(valid.shape)}")
    table = valid.shape
    _check(spiked, torch.bool, table[:-1] + spiked.shape[-1:], "spiked", device)
    _check(valid, torch.bool, table, "valid", device)
    _check(src, torch.int32, table, "src", device)
    _check(dst, torch.int32, table, "dst", device)
    if sign is not None:
        _check(sign, torch.float32, spiked.shape, "sign", device)
    n, e = spiked.shape[-1], table[-1]
    if n >= 1 << 31:
        raise ValueError(f"synaptic_input: {n} neurons a row exceed int32 ids")
    out = torch.zeros(spiked.shape, dtype=torch.float32, device=device)
    rows = valid.numel() // e if e else 0
    if rows and n:
        bits = torch.empty((rows * ((n + 31) // 32),), dtype=torch.int32, device=device)
        p = lambda t: ctypes.c_void_p(t.data_ptr())
        err = build.library().synaptic_input_launch(
            p(src), p(dst), p(valid), p(spiked), None if sign is None else p(sign), p(bits),
            p(out), rows, e, n, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
        build.check(err, "synaptic_input")
    return out
