"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  CUDA sources live in ``src/repro_torch/csrc/``; `_build` compiles
them at first use."""
