"""Functional ops on tensors; `kernels/` wraps the hand-written CUDA kernels."""
