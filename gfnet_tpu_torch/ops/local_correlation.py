"""Local correlation windows around the current flow estimate.

Counterpart of `gfnet_tpu/ops/local_correlation.py` (ref
`utils/local_correlation.py:4-72`): for each query cell on the G x G grid,
the (2r+1)² window of the target map sampled bilinearly (zeros padding,
align_corners=False) at `flow + integer-pixel offsets`, each tap dotted
with the query feature / √C, ordered ky-major.

`local_correlation` launches the hand-written CUDA kernels for CUDA tensors:
K2 (`ops/kernels.py`, `csrc/local_corr.cu`) forward and K3
(`csrc/local_corr_bwd.cu`) for the gradient, which reaches the query only.
CPU tensors take the plain `_local_correlation_patch` with target and flow
detached; `local_corr_dq_plain` is K3's plain version. A shape the kernels
cannot take raises.
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


def _window_patches(target: Tensor, flow: Tensor, radius: int):
    """Each cell's (2r+2)² integer patch of the zero-padded target, (N, win,
    win, C) with N = B·G1·G2, and its fractional offsets fx, fy (N, 1, 1).
    A window that misses the map, or a non-finite flow, lands wholly in the
    zero margin."""
    b, g1, g2, _ = flow.shape
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
    return patches, fx, fy


def _local_correlation_patch(query: Tensor, target: Tensor, flow: Tensor, radius: int) -> Tensor:
    """Plain version of K2. All (2r+1)² taps of a cell share one fractional
    offset on the integer pixel lattice, so one (2r+2)² patch of the
    zero-padded target and a four-corner combine reproduce bilinear
    zeros-padding sampling exactly. Dots and combine in float32."""
    b, g1, g2, c = query.shape
    win = 2 * radius + 2
    patches, fx, fy = _window_patches(target, flow, radius)
    q = query.reshape(b * g1 * g2, 1, 1, c).float()
    s = (patches.float() * q).sum(-1)  # (N, win, win)
    comb = (
        (1 - fy) * (1 - fx) * s[:, : win - 1, : win - 1]
        + (1 - fy) * fx * s[:, : win - 1, 1:]
        + fy * (1 - fx) * s[:, 1:, : win - 1]
        + fy * fx * s[:, 1:, 1:]
    )
    return comb.reshape(b, g1, g2, (2 * radius + 1) ** 2) / float(np.sqrt(c))


def local_corr_dq_plain(g: Tensor, target: Tensor, flow: Tensor, radius: int) -> Tensor:
    """Plain version of K3: the gradient of `_local_correlation_patch` in the
    query, written out. g (B, G1, G2, (2r+1)²) is spread over the (2r+2)²
    patch with the four corner weights (the adjoint of the combine), then
    contracted with the target patch and scaled by 1/√C → (B, G1, G2, C)
    float32. Target and flow get no gradient."""
    b, g1, g2, k = g.shape
    c = target.shape[-1]
    win, taps = 2 * radius + 2, 2 * radius + 1
    patches, fx, fy = _window_patches(target, flow, radius)
    gt = g.float().reshape(b * g1 * g2, taps, taps)
    sw = gt.new_zeros((b * g1 * g2, win, win))
    sw[:, : win - 1, : win - 1] += (1 - fy) * (1 - fx) * gt
    sw[:, : win - 1, 1:] += (1 - fy) * fx * gt
    sw[:, 1:, : win - 1] += fy * (1 - fx) * gt
    sw[:, 1:, 1:] += fy * fx * gt
    dq = torch.einsum("nyx,nyxc->nc", sw, patches.float())
    return dq.reshape(b, g1, g2, c) / float(np.sqrt(c))


class _LocalCorrelationCUDA(torch.autograd.Function):
    """K2 forward, K3 backward. The gradient goes to the query alone."""

    @staticmethod
    def forward(ctx, query: Tensor, target: Tensor, flow: Tensor, radius: int) -> Tensor:
        target = target.contiguous()
        flow = flow.float().contiguous()
        ctx.save_for_backward(target, flow)
        ctx.radius = radius
        return kernels.local_corr(query.contiguous(), target, flow, radius)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad: Tensor):
        target, flow = ctx.saved_tensors
        # the incoming gradient is a slice of a concatenation's, cast from the
        # model dtype: K3 takes it float32 and contiguous
        dq = kernels.local_corr_bwd(grad.float().contiguous(), target, flow, ctx.radius)
        return dq, None, None, None


def local_correlation(query: Tensor, target: Tensor, flow: Tensor, radius: int) -> Tensor:
    """(B, G, G, C) query, (B, H, W, C) target, (B, G, G, 2) flow →
    (B, G, G, (2r+1)²) float32, differentiable in the query only. On CUDA,
    query and target share one storage dtype (float32 or bf16) and
    accumulate in float32."""
    if query.is_cuda:
        return _LocalCorrelationCUDA.apply(query, target, flow, radius)
    return _local_correlation_patch(query, target.detach(), flow.detach(), radius)
