"""Tensor ops: resize, grid sampling, correlation, KDE, attention, local correlation and the CUDA kernels."""
