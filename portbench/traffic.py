"""Synthetic homography pairs, made on the device from a seed.

A frozen copy of the port's evaluation-set generator (`eval/synthetic.py`,
`synth_pair`, `modality_shift`): a multi-octave noise texture, a random crop,
each view warped by its own random four-point perturbation of
`deformation_ratio`, and for a cross-modal pair a photometric re-rendering
of the second view (channels permuted, inverted, gain and bias, mixed,
blurred). The views are resized to `res` and quantized to uint8, as the
evaluation set is stored. Every seed makes the same sizes and the same share
of cross-modal pairs; the seed moves only the content.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
OCTAVES = ((4, 0.45), (16, 0.3), (64, 0.25))


def bicubic(img: Tensor, hw: tuple[int, int]) -> Tensor:
    """(H, W, C) → (h, w, C), bicubic, a = -0.75."""
    return F.interpolate(img.permute(2, 0, 1)[None], size=hw, mode="bicubic", align_corners=False)[0].permute(1, 2, 0)


def make_texture(rng: np.random.Generator, size: int, device) -> Tensor:
    img = torch.zeros((size, size, 3), dtype=torch.float32, device=device)
    for octave, weight in OCTAVES:
        low = rng.uniform(0, 1, (octave, octave, 3)).astype(np.float32)
        img += weight * bicubic(torch.from_numpy(low).to(device), (size, size))
    img -= img.min()
    return img / img.max().clamp_min(1e-6)


def _gaussian_blur(img: Tensor, sigma: float) -> Tensor:
    k = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(k) - (k - 1) * 0.5
    taps = np.exp(-0.5 / (sigma * sigma) * x * x)
    taps = torch.from_numpy((taps / taps.sum()).astype(np.float32)).to(img.device)
    c = img.shape[-1]
    x = F.pad(img.permute(2, 0, 1)[None], (k // 2,) * 4, mode="reflect")
    x = F.conv2d(x, taps.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    x = F.conv2d(x, taps.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return x[0].permute(1, 2, 0)


def modality_shift(img: Tensor, rng: np.random.Generator) -> Tensor:
    """The same geometry under another appearance."""
    const = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(img.device)
    out = img[..., torch.from_numpy(rng.permutation(3)).to(img.device)]
    if rng.uniform() < 0.5:
        out = 1.0 - out
    gain = rng.uniform(0.6, 1.4, (1, 1, 3)).astype(np.float32)
    bias = rng.uniform(-0.15, 0.15, (1, 1, 3)).astype(np.float32)
    out = out * const(gain) + const(bias)
    if rng.uniform() < 0.5:
        mix = rng.uniform(0, 1, (3, 3)).astype(np.float32)
        mix /= mix.sum(axis=1, keepdims=True)
        alpha = rng.uniform(0.3, 1.0)
        out = (1 - alpha) * out + alpha * (out @ const(mix.T))
    if rng.uniform() < 0.5:
        out = _gaussian_blur(out, rng.uniform(0.5, 1.5))
    return out.clamp(0.0, 1.0)


def _inset(da: int, w: int, h: int) -> np.ndarray:
    return np.array([[da // 2, da // 2], [w - da // 2 - 1, da // 2],
                     [w - da // 2 - 1, h - da // 2 - 1], [da // 2, h - da // 2 - 1]], np.float64)


def _solve4(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The homography taking 4 points to 4, in float64."""
    rows, rhs = [], []
    for (x, y), (u, v) in zip(src, dst):
        rows += [[x, y, 1, 0, 0, 0, -u * x, -u * y], [0, 0, 0, x, y, 1, -v * x, -v * y]]
        rhs += [u, v]
    h = np.linalg.solve(np.array(rows, np.float64), np.array(rhs, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def _warp(img: Tensor, H: np.ndarray) -> Tensor:
    """dst(x) = img(H⁻¹ x), bilinear, zeros outside, pixel corners aligned."""
    h, w = img.shape[:2]
    inv = torch.from_numpy(np.linalg.inv(H).astype(np.float32)).to(img.device)
    gy, gx = torch.meshgrid(torch.arange(h, device=img.device, dtype=torch.float32),
                            torch.arange(w, device=img.device, dtype=torch.float32), indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1) @ inv.T
    src = pts[..., :2] / pts[..., 2:3]
    grid = torch.stack([src[..., 0] * (2 / (w - 1)) - 1, src[..., 1] * (2 / (h - 1)) - 1], dim=-1)
    out = F.grid_sample(img.permute(2, 0, 1)[None], grid[None], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[0].permute(1, 2, 0)


def _four_point_view(rng: np.random.Generator, img: Tensor, da: int) -> Tensor:
    h, w = img.shape[:2]
    src = np.array([[rng.integers(0, da), rng.integers(0, da)],
                    [rng.integers(w - da, w), rng.integers(0, da)],
                    [rng.integers(w - da, w), rng.integers(h - da, h)],
                    [rng.integers(0, da), rng.integers(h - da, h)]], np.float64)
    warped = _warp(img, _solve4(src, _inset(da, w, h)))
    return warped[da // 2:h - da // 2, da // 2:w - da // 2]


def synth_pair(rng: np.random.Generator, res: int, deformation_ratio: float, cross_modal: bool,
               device) -> tuple[Tensor, Tensor]:
    """One pair of (res, res, 3) uint8 views of one textured plane."""
    crop = int(res / (1 - deformation_ratio))
    tex = make_texture(rng, res + res // 2, device)
    tex_b = modality_shift(tex, rng) if cross_modal else tex
    side = tex.shape[0]
    if side <= crop:
        raise ValueError(f"texture {side} is not larger than the crop {crop}")
    x0, y0 = int(rng.integers(0, side - crop)), int(rng.integers(0, side - crop))
    da = int(crop * deformation_ratio)
    views = []
    for t in (tex, tex_b):
        v = _four_point_view(rng, t[y0:y0 + crop, x0:x0 + crop], da)
        views.append((bicubic(v, (res, res)).clamp(0, 1) * 255).round().to(torch.uint8))
    return views[0], views[1]


def make_pool(seed: int, size: int, mix: dict, device) -> tuple[Tensor, Tensor]:
    """`size` pairs (size, res, res, 3) as float32 in [0, 1], the uint8 views
    over 255; every second pair is cross-modal."""
    rng = np.random.default_rng([seed, 0])
    pairs = [synth_pair(rng, mix["res"], mix["deformation_ratio"], j % 2 == 1, device) for j in range(size)]
    a = torch.stack([p[0] for p in pairs]).float() / 255.0
    b = torch.stack([p[1] for p in pairs]).float() / 255.0
    return a, b
