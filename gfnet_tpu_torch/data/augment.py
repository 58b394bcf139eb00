"""Photometric augmentations on host (PIL/numpy).

Re-implements the reference's torchvision pipelines (`train.py:74-93`,
`datasets/homography_dataset_large_size.py:17-28`): color jitter
(brightness/contrast/saturation/hue), random grayscale, random Gaussian blur,
shorter-side resize. Parameter conventions follow torchvision (factor sampled
uniformly in [max(0, 1-x), 1+x]; hue in [-x, x]). An own copy of the JAX
package's `data/augment.py`.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter


class ColorJitter:
    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, img: Image.Image, rng: np.random.Generator) -> Image.Image:
        ops = []
        if self.brightness > 0:
            f = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
        if self.contrast > 0:
            f = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f))
        if self.saturation > 0:
            f = rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im: ImageEnhance.Color(im).enhance(f))
        if self.hue > 0:
            shift = rng.uniform(-self.hue, self.hue)

            def hue_op(im, shift=shift):
                hsv = np.array(im.convert("HSV"), np.int16)
                hsv[..., 0] = (hsv[..., 0] + int(shift * 255)) % 256
                return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")

            ops.append(hue_op)
        order = rng.permutation(len(ops))
        for i in order:
            img = ops[i](img)
        return img


class RandomGrayscale:
    def __init__(self, p=0.2):
        self.p = p

    def __call__(self, img: Image.Image, rng: np.random.Generator) -> Image.Image:
        if rng.uniform() < self.p:
            return img.convert("L").convert("RGB")
        return img


class RandomGaussianBlur:
    """(ref `homography_dataset_large_size.py:17-28`)."""

    def __init__(self, p=0.5, radius_min=0.1, radius_max=2.0):
        self.p = p
        self.radius_min = radius_min
        self.radius_max = radius_max

    def __call__(self, img: Image.Image, rng: np.random.Generator) -> Image.Image:
        if rng.uniform() < self.p:
            radius = rng.uniform(self.radius_min, self.radius_max)
            return img.filter(ImageFilter.GaussianBlur(radius))
        return img


class ResizeShorter:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Image.Image, rng=None) -> Image.Image:
        w, h = img.size
        if min(w, h) == self.size:
            return img
        if w < h:
            nw, nh = self.size, max(int(round(h * self.size / w)), 1)
        else:
            nw, nh = max(int(round(w * self.size / h)), 1), self.size
        return img.resize((nw, nh), Image.BILINEAR)


class Compose:
    def __init__(self, ops):
        self.ops = ops

    def __call__(self, img: Image.Image, rng: np.random.Generator) -> Image.Image:
        for op in self.ops:
            img = op(img, rng)
        return img


def real_dataset_transforms() -> Compose:
    """vis_ir_drone / googlemap pipeline (ref `train.py:74-79`)."""
    return Compose(
        [
            ResizeShorter(640),
            ColorJitter(0.2, 0.2, 0.2, 0.2),
            RandomGaussianBlur(p=0.5),
        ]
    )


def glunet_transforms() -> Compose:
    """glunet pipeline (ref `train.py:88-93`)."""
    return Compose(
        [
            ColorJitter(0.6, 0.6, 0.6, 0.2),
            RandomGrayscale(0.2),
            RandomGaussianBlur(p=0.5),
        ]
    )
