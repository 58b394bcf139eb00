"""Host-side random homography pair synthesis.

Numpy/OpenCV re-implementation of the reference's training-pair generator
(`datasets/generate_random_H_large_size.py:6-85`): both views are warped by
independent random 4-point perturbation homographies ("bi" mode), cropped,
and the composed source→target homography is re-derived in the cropped,
resized frame. Runs in data-loader workers on the host CPU (the analogue of
the reference's kornia-on-CPU path). An own copy of the JAX package's
`data/homography_synth.py`.
"""

from __future__ import annotations

import cv2
import numpy as np


def _four_point_warp(
    rng: np.random.Generator, deform_area: int, w: int, h: int, img: np.ndarray, bi: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Random 4-point perturbation warp + center crop
    (ref `generate_random_H_large_size.py:6-36`). img is HWC uint8/float."""
    da = deform_area
    tgt = np.array(
        [
            [da // 2, da // 2],
            [w - da // 2 - 1, da // 2],
            [w - da // 2 - 1, h - da // 2 - 1],
            [da // 2, h - da // 2 - 1],
        ],
        np.float32,
    )
    if bi:
        src = np.array(
            [
                [rng.integers(0, da), rng.integers(0, da)],
                [rng.integers(w - da, w), rng.integers(0, da)],
                [rng.integers(w - da, w), rng.integers(h - da, h)],
                [rng.integers(0, da), rng.integers(h - da, h)],
            ],
            np.float32,
        )
    else:
        src = tgt
    H = cv2.getPerspectiveTransform(src, tgt)
    warped = cv2.warpPerspective(img, H, (w, h), flags=cv2.INTER_LINEAR)
    warped = warped[da // 2 : h - da // 2, da // 2 : w - da // 2]
    return H.astype(np.float32), warped


def _resize(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    return cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)


def _resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(int(round(w * size / h)), 1)
    else:
        nh, nw = max(int(round(h * size / w)), 1), size
    return _resize(img, (nh, nw))


def random_homography_pair(
    img1: np.ndarray,
    img2: np.ndarray,
    crop_size: int,
    input_hw: tuple[int, int],
    deformation_ratio: float = 0.3,
    bi: bool = True,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthesize a training pair (ref `generate_random_H_large_size.py:38-85`).

    img1/img2: HWC aligned images of the same scene (or the same image twice).
    Returns (im_src, im_tgt, H_s2t) with images at input_hw and H_s2t mapping
    source pixels → target pixels in the resized frame.
    """
    rng = rng or np.random.default_rng()
    assert img1.shape == img2.shape
    h1, w1 = img1.shape[:2]
    if w1 <= crop_size or h1 <= crop_size:
        img1 = _resize_shorter(img1, crop_size + 10)
        img2 = _resize_shorter(img2, crop_size + 10)
        h1, w1 = img1.shape[:2]
    x0 = int(rng.integers(0, w1 - crop_size))
    y0 = int(rng.integers(0, h1 - crop_size))
    img1 = img1[y0 : y0 + crop_size, x0 : x0 + crop_size]
    img2 = img2[y0 : y0 + crop_size, x0 : x0 + crop_size]

    h, w = img1.shape[:2]
    da = int(w * deformation_ratio)
    H_1t, img1 = _four_point_warp(rng, da, w, h, img1, bi=True)
    H_2t, img2 = _four_point_warp(rng, da, w, h, img2, bi=bi)
    H_1t2t = H_2t @ np.linalg.inv(H_1t)

    inset = np.array(
        [
            [da // 2, da // 2],
            [w - da // 2 - 1, da // 2],
            [w - da // 2 - 1, h - da // 2 - 1],
            [da // 2, h - da // 2 - 1],
        ],
        np.float32,
    )
    proj = cv2.perspectiveTransform(inset[None], H_1t2t)[0]
    flow = proj - inset
    hc, wc = img1.shape[:2]
    corners = np.array([[0, 0], [wc - 1, 0], [wc - 1, hc - 1], [0, hc - 1]], np.float32)
    H_s2t = cv2.getPerspectiveTransform(corners, corners + flow).astype(np.float32)

    hi, wi = input_hw
    if (hi, wi) != (hc, wc):
        img1 = _resize(img1, input_hw)
        img2 = _resize(img2, input_hw)
        # ref applies the h-ratio on the left and w-ratio on the right
        # (`generate_random_H_large_size.py:77-79`); square frames in practice
        S_l = np.diag([hi / hc, hi / hc, 1.0]).astype(np.float32)
        S_r = np.diag([wi / wc, wi / wc, 1.0]).astype(np.float32)
        H_s2t = S_l @ H_s2t @ np.linalg.inv(S_r)

    return img1, img2, H_s2t  # source, target, H source→target
