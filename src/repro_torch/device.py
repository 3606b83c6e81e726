"""Device resolution for the port's entry points.

The port runs on the CUDA card by default.  The CPU is used only when a
caller asks for it by name (the tests do); asking for CUDA on a machine
without a card raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """Map a device spec onto a `torch.device`; raise if CUDA is missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):    # meta: shapes only (`launch.steps`)
        raise ValueError(f"unsupported device {dev}")
    return dev
