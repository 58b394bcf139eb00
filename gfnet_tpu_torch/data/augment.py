"""Photometric augmentations on uint8 image tensors, on their device.

Counterpart of the JAX package's `data/augment.py` (the reference's
torchvision pipelines, `train.py:74-93`,
`datasets/homography_dataset_large_size.py:17-28`: colour jitter, random
grayscale, random Gaussian blur, shorter-side resize), which runs PIL on the
host. Here an image is an (H, W, 3) uint8 tensor on any device. The numpy
draws stay on the host in the JAX file's order (the factors, the
permutation, the grayscale draw, the blur's two draws), so one `Generator`
draws the same factors; each pixel op repeats PIL's integer arithmetic:

- `blend` is `Image.blend`: float32 `a + alpha * (b - a)`, truncated toward
  zero, clipped (`ImageEnhance.Brightness/Contrast/Color` blend with a
  black, a mean-gray and a grayscale image; Contrast's gray is
  `int(mean(L) + 0.5)`);
- `to_gray` is `convert("L")`: ITU-R 601 in 16-bit fixed point;
- `rgb_to_hsv` / `hsv_to_rgb` are `convert("HSV")` and back, with PIL's
  float32 and float64 steps;
- `gaussian_blur` is `ImageFilter.GaussianBlur`: PIL's extended box blur,
  three passes a direction with fractional end weights, rounded to uint8
  after each; not a true Gaussian;
- `resize` is `Image.resize(..., BILINEAR | BICUBIC)`: antialiased, the
  coefficients rounded to 22 fractional bits, horizontal pass first, each
  pass rounded to uint8. The products are exact integers in float64.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

Tensor = torch.Tensor
PRECISION_BITS = 22  # PIL's Resample.c, 8 bits a channel


# ------------------------------------------------------------- pixel ops
def blend(a: Tensor, b: Tensor, alpha: float) -> Tensor:
    """`Image.blend(a, b, alpha)` of uint8 tensors of one shape."""
    alpha = torch.tensor(alpha, dtype=torch.float32, device=b.device)
    fa = a.to(torch.float32)
    t = fa + alpha * (b.to(torch.int32) - a.to(torch.int32)).to(torch.float32)
    return t.trunc().clamp(0, 255).to(torch.uint8)


def to_gray(img: Tensor) -> Tensor:
    """`convert("L")` of (..., 3) uint8: (..., ) uint8."""
    x = img.to(torch.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16).to(torch.uint8)


def gray_rgb(gray: Tensor) -> Tensor:
    """`convert("L").convert("RGB")`: the gray replicated."""
    return gray[..., None].expand(*gray.shape, 3).contiguous()


def brightness(img: Tensor, factor: float) -> Tensor:
    return blend(torch.zeros_like(img), img, factor)


def contrast(img: Tensor, factor: float) -> Tensor:
    gray = to_gray(img)
    mean = int(gray.to(torch.int64).sum().item() / gray.numel() + 0.5)  # ImageStat's mean
    return blend(torch.full_like(img, mean), img, factor)


def saturation(img: Tensor, factor: float) -> Tensor:
    return blend(gray_rgb(to_gray(img)), img, factor)


def _f32(x: Tensor) -> Tensor:
    """Round float64 to float32 and back: a C assignment to a `float`."""
    return x.to(torch.float32).to(torch.float64)


def rgb_to_hsv(img: Tensor) -> Tensor:
    """`convert("HSV")` of (..., 3) uint8 (Convert.c `rgb2hsv_row`)."""
    x = img.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(r, torch.maximum(g, b))
    minc = torch.minimum(r, torch.minimum(g, b))
    f32 = torch.float32
    cr = (maxc - minc).to(f32)
    safe = torch.where(cr > 0, cr, torch.ones_like(cr))
    s = cr / maxc.clamp_min(1).to(f32)
    rc, gc, bc = ((maxc - c).to(f32) / safe for c in (r, g, b))
    d = torch.float64
    h = torch.where(r == maxc, (bc - gc).to(d),
                    torch.where(g == maxc, _f32((2.0 + rc.to(d)) - bc.to(d)),
                                _f32((4.0 + gc.to(d)) - rc.to(d))))
    h = _f32(torch.fmod(h / 6.0 + 1.0, 1.0))
    uh = (h * 255.0).trunc().clamp(0, 255).to(torch.uint8)
    us = (s.to(d) * 255.0).trunc().clamp(0, 255).to(torch.uint8)
    grey = cr == 0
    zero = torch.zeros_like(uh)
    return torch.stack([torch.where(grey, zero, uh), torch.where(grey, zero, us),
                        maxc.to(torch.uint8)], dim=-1)


def _round_half_away(x: Tensor) -> Tensor:
    return torch.sign(x) * torch.floor(x.abs() + 0.5)


def hsv_to_rgb(hsv: Tensor) -> Tensor:
    """`Image.fromarray(hsv, "HSV").convert("RGB")` (Convert.c `hsv2rgb`)."""
    d = torch.float64
    h, s, v = (hsv[..., i].to(d) for i in range(3))
    i = torch.floor(h * 6.0 / 255.0)
    f = _f32(h * 6.0 / 255.0 - i)
    fs = _f32(s / 255.0)
    p = _round_half_away(v * (1.0 - fs))
    q = _round_half_away(v * (1.0 - (fs.to(torch.float32) * f.to(torch.float32)).to(d)))
    t = _round_half_away(v * (1.0 - fs * (1.0 - f)))
    up, uq, ut = (c.clamp(0, 255).to(torch.uint8) for c in (p, q, t))
    uv = hsv[..., 2]
    sector = torch.remainder(i.to(torch.int64), 6)
    table = torch.stack([
        torch.stack([uv, ut, up], -1), torch.stack([uq, uv, up], -1),
        torch.stack([up, uv, ut], -1), torch.stack([up, uq, uv], -1),
        torch.stack([ut, up, uv], -1), torch.stack([uv, up, uq], -1)], 0)
    rgb = torch.gather(table, 0, sector[None, ..., None].expand(1, *sector.shape, 3))[0]
    return torch.where((hsv[..., 1] == 0)[..., None], uv[..., None].expand_as(rgb), rgb)


def hue(img: Tensor, shift: float) -> Tensor:
    """The JAX package's hue op: HSV, hue + int(shift * 255) mod 256, RGB."""
    hsv = rgb_to_hsv(img)
    hh = torch.remainder(hsv[..., 0].to(torch.int32) + int(shift * 255), 256).to(torch.uint8)
    return hsv_to_rgb(torch.stack([hh, hsv[..., 1], hsv[..., 2]], dim=-1))


def gaussian_blur_radius(radius: float, passes: int = 3) -> float:
    """BoxBlur.c `_gaussian_blur_radius`: the extended box radius, in C's
    float32 and float64 steps."""
    f = np.float32
    sigma2 = f(f(radius) * f(radius)) / f(passes)
    big_l = f(math.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f(math.floor((float(big_l) - 1.0) / 2.0))
    a = (f(2) * small_l + f(1)) * (small_l * (small_l + f(1)) - f(3) * sigma2)
    a = a / (f(6) * (sigma2 - (small_l + f(1)) * (small_l + f(1))))
    return float(f(small_l + a))


def _box_blur_lines(x: Tensor, float_radius: float) -> Tensor:
    """One pass of BoxBlur.c `ImagingLineBoxBlur` along the last dim of an
    int64 tensor of uint8 values: the clamped window of 2r + 1 pixels
    weighted `ww`, the two pixels beyond it weighted `fw`, 24 fractional bits."""
    radius = int(float_radius)
    ww = int(np.float32(1 << 24) / (np.float32(float_radius) * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (radius * 2 + 1) * ww) // 2
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    pad = torch.nn.functional.pad
    csum = pad(torch.cumsum(x[..., torch.clamp(torch.arange(-radius - 1, n + radius, device=x.device), 0, n - 1)],
                            dim=-1), (1, 0))
    # window [i - r, i + r] in the padded line starts at i + 1 (offset r + 1)
    acc = csum[..., idx + 2 * radius + 2] - csum[..., idx + 1]
    far = x[..., torch.clamp(idx - radius - 1, 0, n - 1)] + x[..., torch.clamp(idx + radius + 1, 0, n - 1)]
    return (acc * ww + far * fw + (1 << 23)) >> 24


def gaussian_blur(img: Tensor, radius: float) -> Tensor:
    """`img.filter(ImageFilter.GaussianBlur(radius))` of (H, W, C) uint8."""
    if radius == 0:
        return img.clone()
    r = gaussian_blur_radius(radius)
    x = img.permute(2, 0, 1).to(torch.int64)  # (C, H, W)
    if r != 0:
        for _ in range(3):
            x = _box_blur_lines(x, r)
        x = x.transpose(1, 2)
        for _ in range(3):
            x = _box_blur_lines(x, r)
        x = x.transpose(1, 2)
    return x.to(torch.uint8).permute(1, 2, 0).contiguous()


def _bilinear_filter(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


FILTERS = {"bilinear": (_bilinear_filter, 1.0), "bicubic": (_bicubic_filter, 2.0)}


@functools.lru_cache(maxsize=64)
def resize_coeffs(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """(out_size, in_size) int64 matrix of Resample.c's `precompute_coeffs`
    then `normalize_coeffs_8bpc`: each row's taps in float64, normalized,
    scaled by 2^22 and rounded half away from zero."""
    fn, support = FILTERS[mode]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ss = 1.0 / filterscale
    out = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = fn((np.arange(xmax) + xmin - center + 0.5) * ss)
        ww = 0.0
        for v in w:  # C's running sum, in order
            ww += v
        if ww != 0.0:
            w = w / ww
        k = w * (1 << PRECISION_BITS)
        out[xx, xmin:xmin + xmax] = np.trunc(np.where(w < 0, -0.5 + k, 0.5 + k)).astype(np.int64)
    return out


def _resample_pass(x: Tensor, coeffs: np.ndarray, dim: int) -> Tensor:
    """One pass along `dim` of (H, W, C) values: (Σ p·k + 2^21) >> 22, clipped."""
    k = torch.as_tensor(coeffs, dtype=torch.float64, device=x.device)
    y = torch.tensordot(x.to(torch.float64), k, dims=([dim], [1])).movedim(-1, dim)
    y = torch.floor((y + (1 << (PRECISION_BITS - 1))) / (1 << PRECISION_BITS))
    return y.clamp(0, 255).to(torch.uint8)


def resize(img: Tensor, size: tuple[int, int], mode: str = "bilinear") -> Tensor:
    """`Image.fromarray(img).resize((w, h), BILINEAR | BICUBIC)` of (H, W, C)
    uint8 to `size` = (h, w); the same size is a copy, as in PIL."""
    h, w = img.shape[:2]
    oh, ow = size
    if (oh, ow) == (h, w):
        return img.clone()
    if ow != w:
        img = _resample_pass(img, resize_coeffs(w, ow, mode), 1)
    if oh != h:
        img = _resample_pass(img, resize_coeffs(h, oh, mode), 0)
    return img


# --------------------------------------------------------------- the ops
class ColorJitter:
    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, img: Tensor, rng: np.random.Generator) -> Tensor:
        # As in the JAX file, the three lambdas read `f` when they run, after
        # the last factor was drawn: brightness and contrast take the
        # saturation factor (torchvision draws one a op; JAX's closures do not).
        ops = []
        if self.brightness > 0:
            f = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im: brightness(im, f))
        if self.contrast > 0:
            f = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im: contrast(im, f))
        if self.saturation > 0:
            f = rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im: saturation(im, f))
        if self.hue > 0:
            shift = rng.uniform(-self.hue, self.hue)
            ops.append(lambda im, shift=shift: hue(im, shift))
        order = rng.permutation(len(ops))
        for i in order:
            img = ops[i](img)
        return img


class RandomGrayscale:
    def __init__(self, p=0.2):
        self.p = p

    def __call__(self, img: Tensor, rng: np.random.Generator) -> Tensor:
        if rng.uniform() < self.p:
            return gray_rgb(to_gray(img))
        return img


class RandomGaussianBlur:
    """(ref `homography_dataset_large_size.py:17-28`)."""

    def __init__(self, p=0.5, radius_min=0.1, radius_max=2.0):
        self.p = p
        self.radius_min = radius_min
        self.radius_max = radius_max

    def __call__(self, img: Tensor, rng: np.random.Generator) -> Tensor:
        if rng.uniform() < self.p:
            return gaussian_blur(img, rng.uniform(self.radius_min, self.radius_max))
        return img


class ResizeShorter:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Tensor, rng=None) -> Tensor:
        h, w = img.shape[:2]
        if min(w, h) == self.size:
            return img
        if w < h:
            nw, nh = self.size, max(int(round(h * self.size / w)), 1)
        else:
            nw, nh = max(int(round(w * self.size / h)), 1), self.size
        return resize(img, (nh, nw), "bilinear")


class Compose:
    def __init__(self, ops):
        self.ops = ops

    def __call__(self, img: Tensor, rng: np.random.Generator) -> Tensor:
        for op in self.ops:
            img = op(img, rng)
        return img


def real_dataset_transforms() -> Compose:
    """vis_ir_drone / googlemap pipeline (ref `train.py:74-79`)."""
    return Compose([ResizeShorter(640), ColorJitter(0.2, 0.2, 0.2, 0.2), RandomGaussianBlur(p=0.5)])


def glunet_transforms() -> Compose:
    """glunet pipeline (ref `train.py:88-93`)."""
    return Compose([ColorJitter(0.6, 0.6, 0.6, 0.2), RandomGrayscale(0.2), RandomGaussianBlur(p=0.5)])
