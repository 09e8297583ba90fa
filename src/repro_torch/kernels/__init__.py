"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``), their
wrappers, and their plain PyTorch versions (``ref``)."""
