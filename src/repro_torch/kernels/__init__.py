"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version; `ops` dispatches between them by the tensor's device."""
