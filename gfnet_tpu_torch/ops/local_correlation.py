"""Local correlation windows around the current flow estimate.

Counterpart of `gfnet_tpu/ops/local_correlation.py` (ref
`utils/local_correlation.py:4-72`): for each query cell on the G x G grid,
the (2r+1)² window of the target map sampled bilinearly (zeros padding,
align_corners=False) at `flow + integer-pixel offsets`, each tap dotted
with the query feature / √C, ordered ky-major.

`local_correlation` launches the hand-written CUDA kernel K2
(`ops/kernels.py`, `csrc/local_corr.cu`) for CUDA tensors; CPU tensors take
the plain `_local_correlation_patch`. A shape K2 cannot take raises.
"""

from __future__ import annotations

import numpy as np
import torch

from gfnet_tpu_torch.ops import kernels

Tensor = torch.Tensor


def window_offsets(radius: int, h: int, w: int) -> np.ndarray:
    """(K, 2) xy normalized offsets, K = (2r+1)², row-major in y then x:
    one target pixel per step."""
    r = radius
    oy = np.linspace(-2 * r / h, 2 * r / h, 2 * r + 1)
    ox = np.linspace(-2 * r / w, 2 * r / w, 2 * r + 1)
    gy, gx = np.meshgrid(oy, ox, indexing="ij")
    return np.stack([gx, gy], axis=-1).reshape(-1, 2).astype(np.float32)


def _local_correlation_patch(query: Tensor, target: Tensor, flow: Tensor, radius: int) -> Tensor:
    """Plain version of K2. All (2r+1)² taps of a cell share one fractional
    offset on the integer pixel lattice, so one (2r+2)² patch of the
    zero-padded target and a four-corner combine reproduce bilinear
    zeros-padding sampling exactly. Dots and combine in float32."""
    b, g1, g2, c = query.shape
    _, h, w, _ = target.shape
    win = 2 * radius + 2
    pad = win  # clamped windows land wholly in this zero margin
    flow = flow.float()
    px = ((flow[..., 0] + 1) * w - 1) * 0.5
    py = ((flow[..., 1] + 1) * h - 1) * 0.5
    px = torch.where(torch.isfinite(px), px, torch.full_like(px, -1e9))
    py = torch.where(torch.isfinite(py), py, torch.full_like(py, -1e9))
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = (px - x0).reshape(-1, 1, 1)
    fy = (py - y0).reshape(-1, 1, 1)
    bx = (x0.to(torch.int64) - radius + pad).clamp(0, w + 2 * pad - win).reshape(-1)
    by = (y0.to(torch.int64) - radius + pad).clamp(0, h + 2 * pad - win).reshape(-1)

    tp = torch.nn.functional.pad(target, (0, 0, pad, pad, pad, pad))
    ar = torch.arange(win, device=target.device)
    bidx = torch.arange(b, device=target.device).repeat_interleave(g1 * g2)
    patches = tp[bidx[:, None, None], (by[:, None] + ar)[:, :, None], (bx[:, None] + ar)[:, None, :]]
    q = query.reshape(b * g1 * g2, 1, 1, c).float()
    s = (patches.float() * q).sum(-1)  # (N, win, win)
    comb = (
        (1 - fy) * (1 - fx) * s[:, : win - 1, : win - 1]
        + (1 - fy) * fx * s[:, : win - 1, 1:]
        + fy * (1 - fx) * s[:, 1:, : win - 1]
        + fy * fx * s[:, 1:, 1:]
    )
    return comb.reshape(b, g1, g2, (2 * radius + 1) ** 2) / float(np.sqrt(c))


def local_correlation(query: Tensor, target: Tensor, flow: Tensor, radius: int) -> Tensor:
    """(B, G, G, C) query, (B, H, W, C) target, (B, G, G, 2) flow →
    (B, G, G, (2r+1)²) float32. On CUDA, query and target share one storage
    dtype (float32 or bf16) and accumulate in float32."""
    if query.is_cuda:
        return kernels.local_corr(query.contiguous(), target.contiguous(),
                                  flow.float().contiguous(), radius)
    return _local_correlation_patch(query, target, flow, radius)
