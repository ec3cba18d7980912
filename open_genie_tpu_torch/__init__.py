"""PyTorch / CUDA port of open-genie-tpu for NVIDIA Hopper.

Mirrors the layout of the JAX package (`open_genie_tpu/`), which stays the
numerical reference: `ops/` are plain functions on tensors, `ops/kernels/`
wraps the hand-written CUDA kernels in `csrc/`, `modules/` and `models/`
are `nn.Module`s, and `bridge.py` loads the JAX package's parameters.
Public functions keep the JAX package's channels-last `(B, T, H, W, C)`
layout. This package imports torch and numpy only, never jax.
"""
