"""PyTorch + CUDA port of factored_neus_tpu for NVIDIA Hopper GPUs.

Module names follow the JAX package so each counterpart is easy to find.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; the
hand-written CUDA kernels live in ``csrc/`` and are built at first use.
"""
