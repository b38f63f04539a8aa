"""Kernel backends: plain PyTorch ops and the hand-written CUDA kernels."""
