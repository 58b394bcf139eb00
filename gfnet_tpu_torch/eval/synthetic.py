"""Synthetic homography learnability harness.

Provides an end-to-end train→eval oracle with no external data: textured
random images + `random_homography_pair` (the reference's online synthesis,
`generate_random_H_large_size.py:38-85`) give a supervised stream whose GT
homographies are exact, so a model trained for a few hundred steps must
drive the benchmark MACE (ref `estimation.py:79-92`) far below the
random-weight ~70px-cap baseline. An own copy of the JAX package's
`eval/synthetic.py`. It needs `cv2` (also through
`data/homography_synth.py`), so nothing the GPU smoke script imports may
import it. `benchmark_mace` is not ported yet.
"""

from __future__ import annotations

import numpy as np

from gfnet_tpu_torch.data.homography_synth import random_homography_pair

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def make_texture(rng: np.random.Generator, size: int) -> np.ndarray:
    """Multi-octave smoothed noise (HWC uint8-range float in [0,1]): enough
    structure at every scale for correlation to be informative."""
    import cv2

    img = np.zeros((size, size, 3), np.float32)
    for octave, weight in ((4, 0.45), (16, 0.3), (64, 0.25)):
        low = rng.uniform(0, 1, (octave, octave, 3)).astype(np.float32)
        img += weight * cv2.resize(low, (size, size), interpolation=cv2.INTER_CUBIC)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img


def modality_shift(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Photometric re-rendering of one view: channel permutation + per-channel
    affine (contrast/brightness) + optional inversion + blur.

    Geometry is untouched; appearance diverges the way the reference's
    multimodal pairs do (RGB<->IR, map<->satellite,
    `homography_dataset_large_size.py:59-80`) — so the cross-view decoder is
    exercised under a real appearance gap, not same-texture matching."""
    import cv2

    out = img[..., rng.permutation(3)]
    if rng.uniform() < 0.5:
        out = 1.0 - out
    gain = rng.uniform(0.6, 1.4, (1, 1, 3)).astype(np.float32)
    bias = rng.uniform(-0.15, 0.15, (1, 1, 3)).astype(np.float32)
    out = out * gain + bias
    # channel mixing (grayscale-ish or sensor-crosstalk look)
    if rng.uniform() < 0.5:
        mix = rng.uniform(0, 1, (3, 3)).astype(np.float32)
        mix /= mix.sum(axis=1, keepdims=True)
        alpha = rng.uniform(0.3, 1.0)
        out = (1 - alpha) * out + alpha * (out @ mix.T)
    if rng.uniform() < 0.5:
        sigma = rng.uniform(0.5, 1.5)
        out = cv2.GaussianBlur(out, (0, 0), sigma)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def synth_pair(
    rng: np.random.Generator,
    res: int,
    deformation_ratio: float = 0.15,
    texture_size: int | None = None,
    cross_modal: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One (im_src, im_tgt, H_s2t) sample at `res`, raw [0,1] images.

    cross_modal=True feeds a photometrically re-rendered copy of the texture
    to the second view (appearance gap with exact shared geometry)."""
    tex = make_texture(rng, texture_size or (res + res // 2))
    tex_b = modality_shift(tex, rng) if cross_modal else tex
    crop = int(res / (1 - deformation_ratio))
    return random_homography_pair(
        tex, tex_b, crop_size=crop, input_hw=(res, res),
        deformation_ratio=deformation_ratio, bi=True, rng=rng,
    )


def train_batch(
    rng: np.random.Generator, batch: int, res: int, deformation_ratio: float = 0.15,
    cross_modal_frac: float = 0.0, uint8: bool = False,
) -> dict:
    """Training batch (what train/step.py consumes).

    cross_modal_frac: probability a pair gets the modality-shifted second
    view (the reference trains on mixed-modality lists; `train.py:71-95`).
    uint8=True ships raw 8-bit images (device-side normalization in
    train/step.py): 4x less host->device traffic, and quantization to 8 bits
    matches real datasets' information content (the reference loads 8-bit
    PILs, `homography_dataset_large_size.py:149-190`)."""
    ims, imt, hs = [], [], []
    for _ in range(batch):
        cm = rng.uniform() < cross_modal_frac
        a, b, H = synth_pair(rng, res, deformation_ratio, cross_modal=cm)
        if uint8:
            ims.append((a * 255.0 + 0.5).astype(np.uint8))
            imt.append((b * 255.0 + 0.5).astype(np.uint8))
        else:
            ims.append((a - IMAGENET_MEAN) / IMAGENET_STD)
            imt.append((b - IMAGENET_MEAN) / IMAGENET_STD)
        hs.append(H)
    return {
        "im_A": np.stack(ims),
        "im_B": np.stack(imt),
        "H_s2t": np.stack(hs).astype(np.float32),
    }


def eval_pairs(
    n: int, res: int, deformation_ratio: float = 0.15, seed: int = 1234,
    cross_modal: bool = False,
) -> list[dict]:
    """Fixed benchmark set of raw pairs with exact GT homographies."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a, b, H = synth_pair(rng, res, deformation_ratio, cross_modal=cross_modal)
        out.append({"im_A": a, "im_B": b, "H_s2t": H})
    return out
