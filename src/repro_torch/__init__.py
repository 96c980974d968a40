"""PyTorch/CUDA port of the Anytime Minibatch system (the JAX package
``repro`` is the reference it is tested against).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; kernels are hand-written CUDA C++ for Hopper
(``repro_torch.kernels``) with plain PyTorch versions beside them.
"""
