"""PyTorch/CUDA port of the online-softmax serving stack.

The JAX package ``repro`` stays the reference; this package mirrors its module
layout and imports nothing from it (nor from ``jax``).  Plain tensor code is
PyTorch; the Pallas kernels of the paged serving path are CUDA C++ kernels for
Hopper (``sm_90a``) under ``repro_torch/kernels/csrc``.
"""
