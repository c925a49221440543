"""Benchmark of the PyTorch/CUDA trajectory optimizer (see README.md)."""
