"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and their plain
PyTorch versions; :mod:`.ops` is the public surface."""
