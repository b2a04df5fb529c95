"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. CUDA sources live in ``csrc/`` and are built at first use."""
