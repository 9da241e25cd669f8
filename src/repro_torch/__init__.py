"""CNN2Gate in PyTorch: the int8 CNN flow of :mod:`repro` on CUDA.

The package mirrors ``repro`` module for module.  It imports ``torch``
and numpy only: no JAX, and nothing of the JAX package.  Its entry
points run on CUDA unless the caller passes ``device="cpu"``; without a
card they raise instead of quietly running on the CPU.
"""
