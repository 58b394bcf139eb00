"""Robust homography estimation on the device.

Counterpart of `gfnet_tpu/core/homography.py`: K minimal 4-point hypotheses
solved in one batched (K, 8, 8) solve, inliers counted over a (K, N)
transfer-error table, then a weighted Hartley-normalized DLT refit on the
best hypothesis' inliers, refined by a few Cauchy IRLS steps. Every function
takes leading batch dimensions, so B pairs solve as one (B, K, 8, 8) solve
where the JAX package vmaps.

`ransac_homography` draws the (K, 4) minimal-sample indices as the JAX
package's does, `randint(key, (K, 4), 0, N)` (`utils/jax_random.py`);
`ransac_homography_from_indices` takes them, so a test can feed any.
"""

from __future__ import annotations

import math

import torch

from gfnet_tpu_torch.core.geometry import get_perspective_transform, solve_or_nan, transform_points

Tensor = torch.Tensor


def _normalization_transform(pts: Tensor, w: Tensor) -> Tensor:
    """Weighted Hartley normalization (..., 3, 3): centroid to 0, mean
    distance √2. pts (..., N, 2), w (..., N)."""
    wsum = w.sum(-1) + 1e-12
    mean = (pts * w[..., None]).sum(-2) / wsum[..., None]
    d = ((pts - mean[..., None, :]) ** 2).sum(-1).sqrt()
    s = math.sqrt(2.0) / ((d * w).sum(-1) / wsum + 1e-12)
    T = torch.zeros(*s.shape, 3, 3, dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -s * mean[..., 0]
    T[..., 1, 2] = -s * mean[..., 1]
    T[..., 2, 2] = 1.0
    return T


def dlt_homography(src: Tensor, dst: Tensor, weights: Tensor | None = None) -> Tensor:
    """Weighted DLT homography from N >= 4 correspondences (..., N, 2) →
    (..., 3, 3).

    Fixes h22 = 1 in the normalized frame and solves the 8x8 weighted normal
    equations (the JAX package's default `method="solve"`).
    """
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device) if weights is None else weights
    T1 = _normalization_transform(src, w)
    T2 = _normalization_transform(dst, w)
    s = transform_points(T1, src)
    d = transform_points(T2, dst)
    x, y = s[..., 0], s[..., 1]
    u, v = d[..., 0], d[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y, -u], dim=-1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (..., 2N, 9)
    Wv = torch.cat([w, w], dim=-1)[..., None]
    A8, a9 = A[..., :8], A[..., 8:]
    M8 = (A8 * Wv).mT @ A8 + 1e-8 * torch.eye(8, dtype=A.dtype, device=A.device)
    b8 = -(A8 * Wv).mT @ a9
    h8 = solve_or_nan(M8, b8)[..., 0]
    Hn = torch.cat([h8, torch.ones_like(h8[..., :1])], dim=-1).reshape(*h8.shape[:-1], 3, 3)
    H = torch.linalg.inv(T2) @ Hn @ T1
    h22 = H[..., 2:, 2:]
    return H / torch.where(h22.abs() < 1e-12, torch.full_like(h22, 1e-12), h22)


def transfer_error(H: Tensor, src: Tensor, dst: Tensor) -> Tensor:
    """One-way transfer error |H(src) - dst| per correspondence, (..., N)."""
    return torch.linalg.norm(transform_points(H, src) - dst, dim=-1)


def irls_homography(src: Tensor, dst: Tensor, weights: Tensor, iters: int = 4,
                    sigma: float = 3.0, init_H: Tensor | None = None) -> Tensor:
    """IRLS-refined weighted DLT, Cauchy kernel: w = prior / (1 + (r/σ)²)."""
    H = dlt_homography(src, dst, weights) if init_H is None else init_H
    for _ in range(iters):
        r = transfer_error(H, src, dst)
        H = dlt_homography(src, dst, weights / (1.0 + (r / sigma) ** 2))
    return H


def ransac_homography_from_indices(src: Tensor, dst: Tensor, weights: Tensor | None,
                                   idx: Tensor, threshold: float = 3.0,
                                   irls_iters: int = 4) -> tuple[Tensor, Tensor]:
    """RANSAC over the given (..., K, 4) minimal samples + inlier refit.

    src, dst: (..., N, 2) pixel coords. Returns (H (..., 3, 3), inlier mask
    (..., N)).
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    flat = idx.flatten(-2)[..., None].long()  # (..., K*4, 1)
    pick = lambda p: torch.take_along_dim(p, flat, dim=-2).reshape(*idx.shape, 2)
    Hs = get_perspective_transform(pick(src), pick(dst))  # (..., K, 3, 3)
    finite = torch.isfinite(Hs.flatten(-2)).all(-1)
    err = transfer_error(Hs, src[..., None, :, :], dst[..., None, :, :])  # (..., K, N)
    inl = (err < threshold).to(torch.float32)
    score = (inl * weights[..., None, :]).sum(-1)
    score = torch.where(finite, score, torch.full_like(score, -1.0))
    best = torch.argmax(score, dim=-1)[..., None, None]
    best_inl = torch.take_along_dim(inl, best, dim=-2)[..., 0, :]
    # degenerate input (no hypothesis with 4 inliers): fall back to the priors
    w_fit = torch.where(best_inl.sum(-1, keepdim=True) >= 4, best_inl * weights, weights)
    H = irls_homography(src, dst, w_fit, iters=irls_iters, sigma=threshold)
    return H, transfer_error(H, src, dst) < threshold


def ransac_homography(src: Tensor, dst: Tensor, weights: Tensor | None = None,
                      key=None, num_hypotheses: int = 512, threshold: float = 3.0,
                      irls_iters: int = 4) -> tuple[Tensor, Tensor]:
    """Vectorized RANSAC + IRLS refit on (N, 2) correspondences. Minimal
    samples are drawn uniformly with replacement under the JAX key `key`
    ((2,) uint32; None is `PRNGKey(0)`): a duplicate pick gives a degenerate
    hypothesis that simply scores no inliers."""
    from gfnet_tpu_torch.utils import jax_init, jax_random

    key = jax_init.prng_key(0) if key is None else key
    idx = jax_random.randint(key, (num_hypotheses, 4), 0, src.shape[0], device=src.device)
    return ransac_homography_from_indices(src, dst, weights, idx, threshold, irls_iters)


def corner_error(H_pred: Tensor, H_gt: Tensor, w: float, h: float, cap: float = 70.0) -> Tensor:
    """Mean 4-corner transfer error, capped: the ACE metric (ref `estimation.py:79-92`)."""
    corners = torch.tensor([[0.0, 0.0], [0.0, h - 1], [w - 1, 0.0], [w - 1, h - 1]],
                           dtype=H_pred.dtype, device=H_pred.device)
    err = torch.linalg.norm(transform_points(H_gt, corners) - transform_points(H_pred, corners),
                            dim=-1).mean()
    return torch.clamp(err, max=cap)
