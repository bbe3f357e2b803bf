"""Compute kernels: host exact implementations, PyTorch device code and
the hand-written CUDA kernels (csrc/) with their plain PyTorch versions."""
