"""Separable resize as two matrix products, with `F.interpolate` semantics.

Counterpart of `gfnet_tpu/ops/resize.py`. Each resize is `W_h @ x @ W_w^T`,
with the (out, in) weight matrices built in numpy exactly as the JAX package
builds them, so the antialiased bicubic (pass 1) and bilinear (pass 2) image
resizes, the explicit-scale pos-embed resample and the flow/feature
upsamples give the JAX numbers by construction.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

Tensor = torch.Tensor


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
    if mode in ("nearest", "nearest-exact"):
        ratio = in_size / out_size if scale is None else 1.0 / scale
        pos = out_idx + 0.5 if mode == "nearest-exact" else out_idx
        src = np.minimum(np.floor(pos * ratio), in_size - 1).astype(np.int64)
        W = np.zeros((out_size, in_size))
        W[np.arange(out_size), src] = 1.0
        return W
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
    # the cache outlives the caller's mode: a tensor made under
    # `torch.inference_mode()` could not be saved for a later backward
    with torch.inference_mode(False):
        return torch.as_tensor(W).to(device=device, dtype=dtype)


def interpolate(x: Tensor, size: tuple[int, int] | int, mode: str = "bilinear",
                align_corners: bool = False, scale: tuple[float, float] | None = None,
                antialias: bool = False) -> Tensor:
    """Resize NHWC `x` (B, H, W, C) to `size` (h, w) with two matrix products;
    the weights are rounded to `x.dtype`, as in the JAX package."""
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
