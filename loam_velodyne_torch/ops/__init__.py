"""Tensor operators of the sweep step and their CUDA kernels."""
