"""Attention ops and their CUDA kernels."""
