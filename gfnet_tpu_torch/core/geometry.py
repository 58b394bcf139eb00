"""Projective geometry primitives on torch tensors.

Counterpart of `gfnet_tpu/core/geometry.py`: normalized pixel-center grids,
corner-aligned denormalization, `transform_points`, the 4-point
`get_perspective_transform` and `warp_perspective`. Batched over leading
dimensions; points are (..., N, 2) xy.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def normalized_grid(h: int, w: int, dtype=torch.float32, device=None) -> Tensor:
    """Pixel-center grid in the [-1+1/n, 1-1/n] convention, xy order, (h, w, 2)."""
    ys = torch.linspace(-1 + 1 / h, 1 - 1 / h, h, dtype=dtype, device=device)
    xs = torch.linspace(-1 + 1 / w, 1 - 1 / w, w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def denormalize_corner_aligned(xn: Tensor, h: int, w: int) -> Tensor:
    """[-1,1] normalized → pixel coords, pixel = (n-1) * (x+1)/2
    (ref `estimation.py:26-45`)."""
    x = (w - 1) * (xn[..., 0] + 1) / 2
    y = (h - 1) * (xn[..., 1] + 1) / 2
    return torch.stack([x, y], dim=-1)


def transform_points(H: Tensor, pts: Tensor, eps: float = 1e-8) -> Tensor:
    """Apply projective transform(s) H (..., 3, 3) to points (..., N, 2)."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    out = torch.einsum("...ij,...nj->...ni", H, ph)
    z = out[..., 2:3]
    z = torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps).to(z.dtype), z)
    return out[..., :2] / z


def solve_or_nan(A: Tensor, b: Tensor) -> Tensor:
    """Batched linear solve that returns NaN for singular systems instead of
    raising, as XLA's LU solve does (RANSAC draws with replacement, so
    degenerate minimal sets are routine and must just score no inliers)."""
    x, info = torch.linalg.solve_ex(A, b)
    bad = (info != 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def get_perspective_transform(src: Tensor, dst: Tensor) -> Tensor:
    """Exact homography from 4 correspondences via an 8x8 linear solve.

    src, dst: (..., 4, 2) pixel coords. Returns (..., 3, 3) with H[2,2]=1.
    Both point sets are normalized to unit scale for f32 conditioning.
    """

    def norm_params(p):
        mean = p.mean(dim=-2, keepdim=True)
        scale = (p - mean).abs().mean(dim=(-2, -1), keepdim=True) + 1e-8
        return mean, scale

    sm, ss = norm_params(src)
    dm, ds = norm_params(dst)
    sn = (src - sm) / ss
    dn = (dst - dm) / ds
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], dim=-1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (..., 8, 8)
    b = torch.cat([u, v], dim=-1)[..., None]  # (..., 8, 1)
    h = solve_or_nan(A, b)[..., 0]
    Hn = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(*h.shape[:-1], 3, 3)

    ssq = ss[..., 0, 0]
    dsq = ds[..., 0, 0]
    eye = torch.eye(3, dtype=Hn.dtype, device=Hn.device).expand(Hn.shape).clone()
    T_src = eye / ssq[..., None, None]
    T_src[..., 0, 2] = -sm[..., 0, 0] / ssq
    T_src[..., 1, 2] = -sm[..., 0, 1] / ssq
    T_src[..., 2, 2] = 1.0
    T_dst_inv = eye * dsq[..., None, None]
    T_dst_inv[..., 0, 2] = dm[..., 0, 0]
    T_dst_inv[..., 1, 2] = dm[..., 0, 1]
    T_dst_inv[..., 2, 2] = 1.0
    H = T_dst_inv @ Hn @ T_src
    return H / H[..., 2:3, 2:3]


def warp_perspective(img: Tensor, H: Tensor, out_hw: tuple[int, int],
                     align_corners: bool = True) -> Tensor:
    """Inverse-warp `img` (B, H, W, C) by homography H (B, 3, 3), NHWC:
    dst(x) = src(H^{-1} x), bilinear, zero padding (kornia semantics)."""
    from gfnet_tpu_torch.ops.sampler import grid_sample

    b = img.shape[0]
    oh, ow = out_hw
    gy, gx = torch.meshgrid(
        torch.arange(oh, dtype=img.dtype, device=img.device),
        torch.arange(ow, dtype=img.dtype, device=img.device),
        indexing="ij",
    )
    pts = torch.stack([gx, gy], dim=-1).reshape(1, oh * ow, 2).expand(b, -1, -1)
    src = transform_points(torch.linalg.inv(H), pts).reshape(b, oh, ow, 2)
    ih, iw = img.shape[1], img.shape[2]
    if align_corners:
        grid = torch.stack(
            [src[..., 0] * (2 / max(iw - 1, 1)) - 1, src[..., 1] * (2 / max(ih - 1, 1)) - 1],
            dim=-1,
        )
    else:
        grid = torch.stack([(2 * src[..., 0] + 1) / iw - 1, (2 * src[..., 1] + 1) / ih - 1], dim=-1)
    return grid_sample(img, grid, align_corners=align_corners)
