"""snap_tpu_torch: the PyTorch/CUDA port of snap_tpu for NVIDIA Hopper.

The JAX package ``snap_tpu`` is the reference; this package imports nothing
of it (nor JAX). Module names follow the JAX package's. Hand-written CUDA
kernels live in ``csrc/`` and are built by ``ops/kernels.py``.
"""
