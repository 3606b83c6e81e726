"""PyTorch/CUDA port of the FMM-accelerated Model of Structural Plasticity.

Mirrors the JAX package `repro` module for module (``repro_torch.core.msp``
ports ``repro.core.msp`` and so on); the JAX package stays the reference the
port is tested against.  The port imports neither JAX nor anything of
``repro``.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every hand-written kernel is replaced by its
plain PyTorch version (`repro_torch.kernels.ops`).
"""
