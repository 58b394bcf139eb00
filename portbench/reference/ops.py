"""The reference's operations: resize, grid sampling, attention, global and
local correlation, the kernel density estimate, and the geometry and
homography solve. Plain PyTorch; the model's products take their operands
through `numerics.model`, the sampling's and solve's through
`numerics.solve`, so that the control can lower them.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import numerics

Tensor = torch.Tensor


# ------------------------------------------------------------------- resize
def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (torch's a=-0.75)."""
    at = np.abs(t)
    return np.where(
        at <= 1,
        (a + 2) * at**3 - (a + 3) * at**2 + 1,
        np.where(at < 2, a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a, 0.0),
    )


def _antialias_weight_matrix(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """PIL-style antialiased resize weights (`F.interpolate(antialias=True)`):
    taps within `radius * scale` of the source center, the kernel stretched
    by the scale factor, rows normalized to sum 1. torch's antialiased
    bicubic uses a=-0.5 (PIL), not -0.75."""
    radius = {"bilinear": 1.0, "bicubic": 2.0}[mode]
    scale = in_size / out_size
    support = radius * scale if scale > 1.0 else radius
    kscale = max(scale, 1.0)
    W = np.zeros((out_size, in_size))
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        t = (np.arange(xmin, xmax) - center + 0.5) / kscale
        w = np.maximum(0.0, 1.0 - np.abs(t)) if mode == "bilinear" else _cubic_kernel(t, a=-0.5)
        s = w.sum()
        if s != 0:
            W[i, xmin:xmax] = w / s
    return W


@lru_cache(maxsize=256)
def resize_weight_matrix(in_size: int, out_size: int, mode: str = "bilinear",
                         align_corners: bool = False, scale: float | None = None,
                         antialias: bool = False) -> np.ndarray:
    """The (out_size, in_size) resize weight matrix.

    `scale` (out/in ratio) overrides the implied ratio for the coordinate
    mapping, as torch does for an explicit `scale_factor` (DINOv2 pos-embed).
    """
    if antialias and mode in ("bilinear", "bicubic"):
        if align_corners or scale is not None:
            raise ValueError("antialias takes neither align_corners nor scale")
        return _antialias_weight_matrix(in_size, out_size, mode)
    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = out_idx * ((in_size - 1) / max(out_size - 1, 1))
    else:
        ratio = in_size / out_size if scale is None else 1.0 / scale
        src = (out_idx + 0.5) * ratio - 0.5
    W = np.zeros((out_size, in_size))
    if mode == "bilinear":
        src_c = np.clip(src, 0, in_size - 1)
        lo = np.floor(src_c).astype(np.int64)
        hi = np.minimum(lo + 1, in_size - 1)
        frac = src_c - lo
        W[np.arange(out_size), lo] += 1 - frac
        W[np.arange(out_size), hi] += frac
    elif mode == "bicubic":
        lo = np.floor(src).astype(np.int64)
        frac = src - lo
        for tap in range(-1, 3):
            idx = np.clip(lo + tap, 0, in_size - 1)
            np.add.at(W, (np.arange(out_size), idx), _cubic_kernel(tap - frac))
    else:
        raise ValueError(f"unknown resize mode {mode}")
    return W


@lru_cache(maxsize=128)
def _weight_tensor(in_size, out_size, mode, align_corners, scale, antialias, dtype, device):
    W = resize_weight_matrix(in_size, out_size, mode, align_corners, scale, antialias)
    return torch.as_tensor(W).to(device=device, dtype=dtype)


def interpolate(x: Tensor, size: tuple[int, int] | int, mode: str = "bilinear",
                align_corners: bool = False, scale: tuple[float, float] | None = None,
                antialias: bool = False) -> Tensor:
    """Resize NHWC `x` (B, H, W, C) to `size` (h, w) as W_h · x · W_wᵀ."""
    if isinstance(size, int):
        size = (size, size)
    _, h, w, _ = x.shape
    oh, ow = size
    if (oh, ow) == (h, w) and scale is None:
        return x
    sh = None if scale is None else float(scale[0])
    sw = None if scale is None else float(scale[1])
    Wh = _weight_tensor(h, oh, mode, align_corners, sh, antialias, x.dtype, x.device)
    Ww = _weight_tensor(w, ow, mode, align_corners, sw, antialias, x.dtype, x.device)
    y = torch.einsum("oh,bhwc->bowc", Wh, x)
    return torch.einsum("pw,bowc->bopc", Ww, y)


# ----------------------------------------------------------------- sampling
def grid_sample(img: Tensor, grid: Tensor) -> Tensor:
    """Bilinear, zeros padding, align_corners False: `img` (B, H, W, C) at
    normalized xy `grid` (B, ..., 2) → (B, ..., C), in float32."""
    b, c = img.shape[0], img.shape[-1]
    out_shape = grid.shape[:-1] + (c,)
    g = grid.reshape(b, -1, 1, 2).float()
    out = F.grid_sample(img.permute(0, 3, 1, 2).float(), g, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[..., 0].transpose(1, 2).reshape(out_shape).to(img.dtype)


# ---------------------------------------------------------------- attention
def entropy_invariant_scale(head_dim: int, seq_len: int, train_avg_length: int | None) -> float:
    """head_dim^-0.5 · log(N) / log(train_avg_length)."""
    scale = head_dim**-0.5
    if train_avg_length is not None:
        scale *= math.log(seq_len) / math.log(train_avg_length)
    return scale


def attention(q: Tensor, k: Tensor, v: Tensor, scale: float | None = None, block: int = 2) -> Tensor:
    """Softmax attention over (B, N, H, D) → (B, N, H, D), `block` rows of
    the batch at a time so that the logits fit."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out = []
    for s in range(0, q.shape[0], block):
        qb, kb, vb = (numerics.model(t[s:s + block].float()) for t in (q, k, v))
        logits = torch.einsum("bnhd,bmhd->bhnm", qb, kb) * scale
        probs = numerics.model(torch.softmax(logits, dim=-1))
        out.append(torch.einsum("bhnm,bmhd->bnhd", probs, vb))
    return torch.cat(out)


# -------------------------------------------------------------- correlation
def normalized_grid(h: int, w: int, dtype=torch.float32, device=None) -> Tensor:
    """Pixel-centre grid in the [-1+1/n, 1-1/n] convention, xy order, (h, w, 2)."""
    ys = torch.linspace(-1 + 1 / h, 1 - 1 / h, h, dtype=dtype, device=device)
    xs = torch.linspace(-1 + 1 / w, 1 - 1 / w, w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def corr_volume_flow(feat0: Tensor, feat1: Tensor) -> Tensor:
    """The global correlation of the coarsest features and the softmax
    expectation of the target grid → the initial flow (B, H0, W0, 2)."""
    b, h0, w0, ch = feat0.shape
    _, h1, w1, _ = feat1.shape
    f0 = numerics.model(feat0.reshape(b, h0 * w0, ch).float())
    f1 = numerics.model(feat1.reshape(b, h1 * w1, ch).float())
    corr = torch.einsum("bjc,bic->bji", f1, f0) / math.sqrt(ch)
    p = torch.softmax(corr, dim=1)
    grid = normalized_grid(h1, w1, device=corr.device).reshape(h1 * w1, 2)
    return torch.einsum("bji,jd->bid", p, grid).reshape(b, h0, w0, 2)


def _window_patches(target: Tensor, flow: Tensor, radius: int):
    """Each cell's (2r+2)² integer patch of the zero-padded target (N, win,
    win, C), N = B·G1·G2, and its fractional offsets fx, fy (N, 1, 1)."""
    b, g1, g2, _ = flow.shape
    _, h, w, _ = target.shape
    win = 2 * radius + 2
    pad = win
    flow = flow.float()
    px = ((flow[..., 0] + 1) * w - 1) * 0.5
    py = ((flow[..., 1] + 1) * h - 1) * 0.5
    px = torch.where(torch.isfinite(px), px, torch.full_like(px, -1e9))
    py = torch.where(torch.isfinite(py), py, torch.full_like(py, -1e9))
    x0, y0 = torch.floor(px), torch.floor(py)
    fx = (px - x0).reshape(-1, 1, 1)
    fy = (py - y0).reshape(-1, 1, 1)
    bx = (x0.to(torch.int64) - radius + pad).clamp(0, w + 2 * pad - win).reshape(-1)
    by = (y0.to(torch.int64) - radius + pad).clamp(0, h + 2 * pad - win).reshape(-1)
    tp = F.pad(target, (0, 0, pad, pad, pad, pad))
    ar = torch.arange(win, device=target.device)
    bidx = torch.arange(b, device=target.device).repeat_interleave(g1 * g2)
    patches = tp[bidx[:, None, None], (by[:, None] + ar)[:, :, None], (bx[:, None] + ar)[:, None, :]]
    return patches, fx, fy


def local_correlation(query: Tensor, target: Tensor, flow: Tensor, radius: int) -> Tensor:
    """(B, G, G, C) query against the (2r+1)² bilinear taps of the target
    (B, H, W, C) around each cell's flow, zeros padding, / √C →
    (B, G, G, (2r+1)²) float32. All taps of a cell share one fractional
    offset, so one (2r+2)² patch and a four-corner combine give them; one
    batch row at a time."""
    b, g1, g2, c = query.shape
    win = 2 * radius + 2
    out = []
    for i in range(b):
        patches, fx, fy = _window_patches(target[i:i + 1], flow[i:i + 1], radius)
        q = numerics.model(query[i].reshape(g1 * g2, 1, 1, c).float())
        s = (numerics.model(patches.float()) * q).sum(-1)
        comb = ((1 - fy) * (1 - fx) * s[:, :win - 1, :win - 1] + (1 - fy) * fx * s[:, :win - 1, 1:]
                + fy * (1 - fx) * s[:, 1:, :win - 1] + fy * fx * s[:, 1:, 1:])
        out.append(comb.reshape(1, g1, g2, (2 * radius + 1) ** 2))
    return torch.cat(out) / float(np.sqrt(c))


# ------------------------------------------------------------------ density
def kde(x: Tensor, std: float = 0.1, block: int = 4096) -> Tensor:
    """density[..., i] = Σ_j exp(-|x_i - x_j|² / (2 std²)), x (..., N, D),
    in blocks of rows (`block` rows over the whole batch a step)."""
    x = x.float()
    sq = (x * x).sum(-1)
    inv = -1.0 / (2 * std * std)
    rows = max(1, block // sq[..., 0].numel())
    xs = numerics.solve(x)
    out = []
    for s in range(0, x.shape[-2], rows):
        d2 = (sq[..., s:s + rows, None] + sq[..., None, :] - 2.0 * (xs[..., s:s + rows, :] @ xs.mT)).clamp_min(0.0)
        out.append(torch.exp(d2 * inv).sum(-1))
    return torch.cat(out, dim=-1)


# ----------------------------------------------------------------- geometry
def denormalize_corner_aligned(xn: Tensor, h: int, w: int) -> Tensor:
    """[-1, 1] normalized → pixels, pixel = (n - 1)(x + 1)/2."""
    x = (w - 1) * (xn[..., 0] + 1) / 2
    y = (h - 1) * (xn[..., 1] + 1) / 2
    return torch.stack([x, y], dim=-1)


def transform_points(H: Tensor, pts: Tensor, eps: float = 1e-8) -> Tensor:
    """Projective transform(s) H (..., 3, 3) of points (..., N, 2)."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    out = torch.einsum("...ij,...nj->...ni", numerics.solve(H), numerics.solve(ph))
    z = out[..., 2:3]
    z = torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps).to(z.dtype), z)
    return out[..., :2] / z


def solve_or_nan(A: Tensor, b: Tensor) -> Tensor:
    """Batched solve, NaN for a singular system."""
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



# ------------------------------------------------------------------- solve
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
    A8w, A8s, a9s = numerics.solve(A8 * Wv), numerics.solve(A8), numerics.solve(a9)
    M8 = A8w.mT @ A8s + 1e-8 * torch.eye(8, dtype=A.dtype, device=A.device)
    b8 = -A8w.mT @ a9s
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

