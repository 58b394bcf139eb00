"""Bilinear grid sampling, NHWC, with `F.grid_sample` semantics.

Counterpart of `gfnet_tpu/ops/sampler.py:138-214`. The JAX package leaves
this gather to XLA; here it is the library's `F.grid_sample` (bilinear,
zeros padding, align_corners=False on the model path; "border" padding
clamps to the edge pixels). Sampling runs in float32 whatever the storage
type: the normalized coordinates of a 320-cell grid need more than bf16's 8
bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

PADDING_MODES = ("zeros", "border")  # the JAX package's


def grid_sample(img: Tensor, grid: Tensor, align_corners: bool = False, padding_mode: str = "zeros") -> Tensor:
    """Sample `img` (B, H, W, C) at normalized xy `grid` (B, ..., 2) → (B, ..., C).
    `padding_mode`: "zeros" (taps off the map read 0) or "border" (they read
    the nearest edge pixel); any other value raises."""
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"grid_sample: padding_mode {padding_mode!r} not in {PADDING_MODES}")
    b, c = img.shape[0], img.shape[-1]
    out_shape = grid.shape[:-1] + (c,)
    g = grid.reshape(b, -1, 1, 2).to(torch.float32)
    out = F.grid_sample(img.permute(0, 3, 1, 2).to(torch.float32), g, mode="bilinear",
                        padding_mode=padding_mode, align_corners=align_corners)
    return out[..., 0].transpose(1, 2).reshape(out_shape).to(img.dtype)
