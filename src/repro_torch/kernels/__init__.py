"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version; sources in ``repro_torch/csrc``, built by ``_build``."""
