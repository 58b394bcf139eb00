"""Synthetic homography pairs: the evaluation set and the training stream.

Provides an end-to-end train→eval oracle with no external data: textured
random images + a random homography pair (the reference's online synthesis,
`generate_random_H_large_size.py:38-85`) give pairs whose GT homographies
are exact, so a model trained for a few hundred steps must drive the
benchmark MACE (ref `estimation.py:79-92`) far below the random-weight
~70px-cap baseline. Counterpart of the JAX package's `eval/synthetic.py`.

`eval_pairs` makes the evaluation set with tensor ops on any device (no
`cv2` on the card's path): bicubic `F.interpolate`, a separable Gaussian
blur, and `data/homography_synth.random_homography_pair` (`core/geometry`'s
four-point solve and bilinear `warp_perspective`).
Its numpy draws come in the JAX package's order, so one seed gives the same
textures, homographies and photometric shifts; the homographies are solved
in float64 on the host and rounded to float32 where the JAX package's are;
the images come out as uint8, as `tools/make_synth_valdir.py` writes them,
and differ from the `cv2` ones by interpolation rounding (a few levels).

`train_batch` makes the training stream. On the host (no `device`) it
keeps the JAX package's `cv2` arithmetic bit for bit (`_synth_pair_cv2`,
`data/homography_synth.random_homography_pair_cv2`) and imports `cv2` when
called; given a `device`, it makes the same pairs from the same numpy draws
with the tensor ops of `eval_pairs` (`synth_pair`), as the card's learning
run does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gfnet_tpu_torch.data.homography_synth import bicubic, random_homography_pair

Tensor = torch.Tensor

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
OCTAVES = ((4, 0.45), (16, 0.3), (64, 0.25))


# ------------------------------------------------ the evaluation set (torch)
def make_texture(rng: np.random.Generator, size: int, device="cpu") -> Tensor:
    """Multi-octave smoothed noise (size, size, 3) float32 in [0, 1]: enough
    structure at every scale for correlation to be informative."""
    img = torch.zeros((size, size, 3), dtype=torch.float32, device=device)
    for octave, weight in OCTAVES:
        low = rng.uniform(0, 1, (octave, octave, 3)).astype(np.float32)
        img += weight * bicubic(torch.from_numpy(low).to(device), (size, size))
    img -= img.min()
    return img / img.max().clamp_min(1e-6)


def _gaussian_blur(img: Tensor, sigma: float) -> Tensor:
    """cv2.GaussianBlur(img, (0, 0), sigma) of a float32 (H, W, C) image: a
    separable kernel of cvRound(8σ + 1) | 1 taps, reflect-101 borders."""
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
    """Photometric re-rendering of one view: channel permutation + per-channel
    affine (contrast/brightness) + optional inversion + blur.

    Geometry is untouched; appearance diverges the way the reference's
    multimodal pairs do (RGB<->IR, map<->satellite,
    `homography_dataset_large_size.py:59-80`) — so the cross-view decoder is
    exercised under a real appearance gap, not same-texture matching."""
    const = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(img.device)
    out = img[..., torch.from_numpy(rng.permutation(3)).to(img.device)]
    if rng.uniform() < 0.5:
        out = 1.0 - out
    gain = rng.uniform(0.6, 1.4, (1, 1, 3)).astype(np.float32)
    bias = rng.uniform(-0.15, 0.15, (1, 1, 3)).astype(np.float32)
    out = out * const(gain) + const(bias)
    # channel mixing (grayscale-ish or sensor-crosstalk look)
    if rng.uniform() < 0.5:
        mix = rng.uniform(0, 1, (3, 3)).astype(np.float32)
        mix /= mix.sum(axis=1, keepdims=True)
        alpha = rng.uniform(0.3, 1.0)
        out = (1 - alpha) * out + alpha * (out @ const(mix.T))
    if rng.uniform() < 0.5:
        out = _gaussian_blur(out, rng.uniform(0.5, 1.5))
    return out.clamp(0.0, 1.0)


def synth_pair(rng: np.random.Generator, res: int, deformation_ratio: float = 0.15,
               texture_size: int | None = None, cross_modal: bool = False,
               device="cpu") -> tuple[Tensor, Tensor, np.ndarray]:
    """One (im_src, im_tgt, H_s2t) sample at `res`: float32 [0, 1] images on
    `device`, H_s2t on the host.

    cross_modal=True feeds a photometrically re-rendered copy of the texture
    to the second view (appearance gap with exact shared geometry)."""
    tex = make_texture(rng, texture_size or (res + res // 2), device)
    tex_b = modality_shift(tex, rng) if cross_modal else tex
    crop = int(res / (1 - deformation_ratio))
    return random_homography_pair(tex, tex_b, crop_size=crop, input_hw=(res, res),
                                  deformation_ratio=deformation_ratio, bi=True, rng=rng)


class SynthPairs(list):
    """A list of `{im_A, im_B, H_s2t}` pairs with the `.dataset` name
    `eval/benchmark.HomographyBenchmark` reports them under."""

    def __init__(self, dataset: str, pairs=()):
        super().__init__(pairs)
        self.dataset = dataset


def to_uint8(x: Tensor) -> Tensor:
    """[0, 1] float → uint8, as `tools/make_synth_valdir.py` writes a PNG."""
    return (x.clamp(0, 1) * 255).round().to(torch.uint8)


def eval_pairs(n: int, res: int, deformation_ratio: float = 0.15, seed: int = 1234,
               cross_modal: bool = False, device="cuda") -> SynthPairs:
    """Fixed benchmark set of pairs with exact GT homographies, made on
    `device`: uint8 (res, res, 3) images and float32 (3, 3) H_s2t, named
    "synthetic" or "synthetic_crossmodal" as the JAX package's val dirs."""
    from gfnet_tpu_torch.matcher.api import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = SynthPairs("synthetic_crossmodal" if cross_modal else "synthetic")
    for _ in range(n):
        a, b, H = synth_pair(rng, res, deformation_ratio, cross_modal=cross_modal, device=device)
        out.append({"im_A": to_uint8(a), "im_B": to_uint8(b), "H_s2t": H})
    return out


def benchmark_mace(matcher, pairs: list[dict], num_matches: int = 2000, seed=0):
    """MACE over the synthetic set via the full match→sample→solve pipeline,
    one pair at a time under the JAX package's key chain: `key =
    PRNGKey(seed)`, then `key, k = split(key)` a pair."""
    from gfnet_tpu_torch.eval.benchmark import evaluate_pair
    from gfnet_tpu_torch.utils import jax_init

    key, errors = jax_init.prng_key(seed), []
    for s in pairs:
        key, k = jax_init.split(key)
        errors.append(evaluate_pair(matcher, s["im_A"], s["im_B"], s["H_s2t"], key=k,
                                    num_matches=num_matches)[0])
    return float(np.mean(errors)), errors


# ------------------------------------- the training stream (cv2, bit for bit)
def _make_texture_cv2(rng: np.random.Generator, size: int) -> np.ndarray:
    import cv2

    img = np.zeros((size, size, 3), np.float32)
    for octave, weight in OCTAVES:
        low = rng.uniform(0, 1, (octave, octave, 3)).astype(np.float32)
        img += weight * cv2.resize(low, (size, size), interpolation=cv2.INTER_CUBIC)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img


def _modality_shift_cv2(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    import cv2

    out = img[..., rng.permutation(3)]
    if rng.uniform() < 0.5:
        out = 1.0 - out
    gain = rng.uniform(0.6, 1.4, (1, 1, 3)).astype(np.float32)
    bias = rng.uniform(-0.15, 0.15, (1, 1, 3)).astype(np.float32)
    out = out * gain + bias
    if rng.uniform() < 0.5:
        mix = rng.uniform(0, 1, (3, 3)).astype(np.float32)
        mix /= mix.sum(axis=1, keepdims=True)
        alpha = rng.uniform(0.3, 1.0)
        out = (1 - alpha) * out + alpha * (out @ mix.T)
    if rng.uniform() < 0.5:
        sigma = rng.uniform(0.5, 1.5)
        out = cv2.GaussianBlur(out, (0, 0), sigma)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def _synth_pair_cv2(rng: np.random.Generator, res: int, deformation_ratio: float,
                    cross_modal: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    from gfnet_tpu_torch.data.homography_synth import random_homography_pair_cv2 as pair_cv2

    tex = _make_texture_cv2(rng, res + res // 2)
    tex_b = _modality_shift_cv2(tex, rng) if cross_modal else tex
    crop = int(res / (1 - deformation_ratio))
    return pair_cv2(tex, tex_b, crop_size=crop, input_hw=(res, res),
                    deformation_ratio=deformation_ratio, bi=True, rng=rng)


def train_batch(
    rng: np.random.Generator, batch: int, res: int, deformation_ratio: float = 0.15,
    cross_modal_frac: float = 0.0, uint8: bool = False, device=None,
) -> dict:
    """Training batch (what train/step.py consumes).

    cross_modal_frac: probability a pair gets the modality-shifted second
    view (the reference trains on mixed-modality lists; `train.py:71-95`).
    uint8=True ships raw 8-bit images (device-side normalization in
    train/step.py): 4x less host->device traffic, and quantization to 8 bits
    matches real datasets' information content (the reference loads 8-bit
    PILs, `homography_dataset_large_size.py:149-190`).
    device=None: numpy arrays from the `cv2` pairs; a device: tensors there
    from `synth_pair`, the same draws in the same order, the images within
    interpolation rounding of the `cv2` ones (H_s2t on the device too)."""
    ims, imt, hs = [], [], []
    for _ in range(batch):
        cm = rng.uniform() < cross_modal_frac
        if device is None:
            a, b, H = _synth_pair_cv2(rng, res, deformation_ratio, cm)
        else:
            a, b, H = synth_pair(rng, res, deformation_ratio, cross_modal=cm, device=device)
        for out, im in ((ims, a), (imt, b)):
            if uint8:
                out.append((im * 255.0 + 0.5).astype(np.uint8) if device is None
                           else (im * 255.0 + 0.5).to(torch.uint8))
            else:
                mean, std = ((IMAGENET_MEAN, IMAGENET_STD) if device is None else
                             (torch.from_numpy(IMAGENET_MEAN).to(im.device),
                              torch.from_numpy(IMAGENET_STD).to(im.device)))
                out.append((im - mean) / std)
        hs.append(H)
    if device is None:
        return {"im_A": np.stack(ims), "im_B": np.stack(imt),
                "H_s2t": np.stack(hs).astype(np.float32)}
    return {"im_A": torch.stack(ims), "im_B": torch.stack(imt),
            "H_s2t": torch.from_numpy(np.stack(hs).astype(np.float32)).to(ims[0].device)}
