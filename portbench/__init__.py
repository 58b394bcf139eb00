"""The benchmark of the PyTorch/H100 port, `gfnet_tpu_torch`: see README.md."""
