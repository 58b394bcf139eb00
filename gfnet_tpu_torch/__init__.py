"""PyTorch/CUDA port of the GFNet dense-matching + homography engine.

Runs `GFNetMatcher.estimate_homography` end to end, and the training path
(`train/`, `python -m gfnet_tpu_torch.cli.train`), on an NVIDIA H100 with
hand-written CUDA kernels for attention, local correlation and its gradient
(`csrc/`, loaded by `ops/kernels.py`), and on the CPU with their plain
PyTorch versions. Imports torch and numpy only; the JAX package
`gfnet_tpu` is the reference it is tested against.

    from gfnet_tpu_torch.config import ModelConfig
    from gfnet_tpu_torch.matcher import GFNetMatcher

    matcher = GFNetMatcher.from_pretrained(ckpt_path="head.npz")  # device="cuda"
    H = matcher.estimate_homography(im_a, im_b)
"""
