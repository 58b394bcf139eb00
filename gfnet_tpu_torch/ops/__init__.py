"""Tensor ops: resize, grid sampling, correlation, KDE, attention, local correlation,
the ViT's residual stream and the CUDA kernels."""
