"""Global correlation volume + softmax position-expectation flow init.

Counterpart of `gfnet_tpu/ops/correlation.py:23-58` (ref
`model/network.py:415-440`): the (B, G², G²) similarity of the coarsest
grid's features and the softmax expectation of the target-cell grid.
Features are NHWC (B, H, W, C).
"""

from __future__ import annotations

import math

import torch

from gfnet_tpu_torch.core.geometry import normalized_grid

Tensor = torch.Tensor


def global_correlation(feat0: Tensor, feat1: Tensor) -> Tensor:
    """corr[b, j, i] = <feat1[b, j], feat0[b, i]> / sqrt(C), float32,
    (B, H1*W1, H0*W0) target-major."""
    b, h0, w0, ch = feat0.shape
    _, h1, w1, _ = feat1.shape
    f0 = feat0.reshape(b, h0 * w0, ch).to(torch.float32)
    f1 = feat1.reshape(b, h1 * w1, ch).to(torch.float32)
    return torch.einsum("bjc,bic->bji", f1, f0) / math.sqrt(ch)


def softmax_pos_embed(corr: Tensor, h1: int, w1: int) -> Tensor:
    """Expected target coordinate under the softmax over target cells:
    (B, H1*W1, H0*W0) → flow (B, H0, W0, 2) of normalized xy."""
    b, n1, n0 = corr.shape
    if n1 != h1 * w1:
        raise ValueError(f"corr has {n1} target cells, grid is {h1}x{w1}")
    p = torch.softmax(corr, dim=1)
    grid = normalized_grid(h1, w1, device=corr.device).reshape(n1, 2)
    flow = torch.einsum("bji,jd->bid", p, grid)
    side = int(n0**0.5)
    return flow.reshape(b, side, side, 2)


def corr_volume_flow(feat0: Tensor, feat1: Tensor) -> Tensor:
    """Correlation volume + softmax expectation → initial flow (B, H0, W0, 2)."""
    _, h1, w1, _ = feat1.shape
    return softmax_pos_embed(global_correlation(feat0, feat1), h1, w1)
