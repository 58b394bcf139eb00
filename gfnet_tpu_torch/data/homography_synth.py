"""Random homography pair synthesis on tensors.

Counterpart of the JAX package's `data/homography_synth.py`, the
reference's training-pair generator (`datasets/generate_random_H_large_size.py:6-85`):
both views are warped by independent random 4-point perturbation
homographies ("bi" mode), cropped, and the composed source→target homography
is re-derived in the cropped, resized frame. `random_homography_pair` takes
(H, W, C) float32 tensors on any device: bicubic `F.interpolate` (cv2's
INTER_CUBIC mapping and a = -0.75), `core/geometry`'s bilinear
`warp_perspective`, the four-point solves in float64 on the host. Its numpy
draws are the JAX package's, in its order, so one seed gives the same
crops and homographies (to float32 rounding); the images differ from cv2's
by interpolation rounding. `random_homography_pair_cv2` keeps the JAX
package's cv2 arithmetic bit for bit for the host stream of
`eval/synthetic.train_batch`, and imports cv2 only when called.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gfnet_tpu_torch.core.geometry import get_perspective_transform, transform_points, warp_perspective

Tensor = torch.Tensor


def bicubic(img: Tensor, hw: tuple[int, int]) -> Tensor:
    """(H, W, C) float32 → (h, w, C), cv2.INTER_CUBIC's mapping and a = -0.75."""
    x = img.permute(2, 0, 1)[None]
    return F.interpolate(x, size=hw, mode="bicubic", align_corners=False)[0].permute(1, 2, 0)


def _solve4(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getPerspectiveTransform: the float64 homography taking 4 points to 4."""
    f64 = lambda p: torch.from_numpy(np.asarray(p, np.float64))
    return get_perspective_transform(f64(src), f64(dst)).numpy()


def _inset(da: int, w: int, h: int) -> np.ndarray:
    return np.array([[da // 2, da // 2], [w - da // 2 - 1, da // 2],
                     [w - da // 2 - 1, h - da // 2 - 1], [da // 2, h - da // 2 - 1]], np.float32)


def _four_point_warp(rng: np.random.Generator, da: int, w: int, h: int, img: Tensor,
                     bi: bool) -> tuple[np.ndarray, Tensor]:
    """Random 4-point perturbation warp + center crop
    (ref `generate_random_H_large_size.py:6-36`), bilinear, zeros outside."""
    tgt = _inset(da, w, h)
    if bi:
        src = np.array([[rng.integers(0, da), rng.integers(0, da)],
                        [rng.integers(w - da, w), rng.integers(0, da)],
                        [rng.integers(w - da, w), rng.integers(h - da, h)],
                        [rng.integers(0, da), rng.integers(h - da, h)]], np.float32)
    else:
        src = tgt
    H = _solve4(src, tgt)
    H_t = torch.from_numpy(H.astype(np.float32)).to(img.device)
    warped = warp_perspective(img[None], H_t[None], (h, w), align_corners=True)[0]
    return H.astype(np.float32), warped[da // 2:h - da // 2, da // 2:w - da // 2]


def _resize_shorter(img: Tensor, size: int) -> Tensor:
    h, w = img.shape[:2]
    if h < w:
        return bicubic(img, (size, max(int(round(w * size / h)), 1)))
    return bicubic(img, (max(int(round(h * size / w)), 1), size))


def random_homography_pair(img1: Tensor, img2: Tensor, crop_size: int, input_hw: tuple[int, int],
                           deformation_ratio: float = 0.3, bi: bool = True,
                           rng: np.random.Generator | None = None
                           ) -> tuple[Tensor, Tensor, np.ndarray]:
    """`data/homography_synth.random_homography_pair` with tensor images
    (HWC float32, on any device): (im_src, im_tgt, H_s2t), images at
    input_hw, H_s2t (float32, host) mapping source pixels → target pixels."""
    rng = rng or np.random.default_rng()
    assert img1.shape == img2.shape
    h1, w1 = img1.shape[:2]
    if w1 <= crop_size or h1 <= crop_size:
        img1 = _resize_shorter(img1, crop_size + 10)
        img2 = _resize_shorter(img2, crop_size + 10)
        h1, w1 = img1.shape[:2]
    x0 = int(rng.integers(0, w1 - crop_size))
    y0 = int(rng.integers(0, h1 - crop_size))
    img1 = img1[y0:y0 + crop_size, x0:x0 + crop_size]
    img2 = img2[y0:y0 + crop_size, x0:x0 + crop_size]

    h, w = img1.shape[:2]
    da = int(w * deformation_ratio)
    H_1t, img1 = _four_point_warp(rng, da, w, h, img1, bi=True)
    H_2t, img2 = _four_point_warp(rng, da, w, h, img2, bi=bi)
    H_1t2t = H_2t @ np.linalg.inv(H_1t)

    inset = _inset(da, w, h)
    # cv2.perspectiveTransform: float64 arithmetic, float32 result
    proj = transform_points(torch.from_numpy(H_1t2t.astype(np.float64)),
                            torch.from_numpy(inset.astype(np.float64))).numpy().astype(np.float32)
    flow = proj - inset
    hc, wc = img1.shape[:2]
    corners = np.array([[0, 0], [wc - 1, 0], [wc - 1, hc - 1], [0, hc - 1]], np.float32)
    H_s2t = _solve4(corners, corners + flow).astype(np.float32)

    hi, wi = input_hw
    if (hi, wi) != (hc, wc):
        img1 = bicubic(img1, input_hw)
        img2 = bicubic(img2, input_hw)
        # ref applies the h-ratio on the left and w-ratio on the right
        # (`generate_random_H_large_size.py:77-79`); square frames in practice
        S_l = np.diag([hi / hc, hi / hc, 1.0]).astype(np.float32)
        S_r = np.diag([wi / wc, wi / wc, 1.0]).astype(np.float32)
        H_s2t = S_l @ H_s2t @ np.linalg.inv(S_r)
    return img1, img2, H_s2t



# ------------------------------------------------- the JAX package's cv2 copy
def _four_point_warp_cv2(
    rng: np.random.Generator, deform_area: int, w: int, h: int, img: np.ndarray, bi: bool
) -> tuple[np.ndarray, np.ndarray]:
    """`_four_point_warp` in cv2 (the JAX package's arithmetic). img is HWC uint8/float."""
    import cv2

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


def _resize_cv2(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    import cv2

    return cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)


def _resize_shorter_cv2(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(int(round(w * size / h)), 1)
    else:
        nh, nw = max(int(round(h * size / w)), 1), size
    return _resize_cv2(img, (nh, nw))


def random_homography_pair_cv2(
    img1: np.ndarray,
    img2: np.ndarray,
    crop_size: int,
    input_hw: tuple[int, int],
    deformation_ratio: float = 0.3,
    bi: bool = True,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`random_homography_pair` on numpy images with the JAX package's cv2
    arithmetic, bit for bit (`eval/synthetic.train_batch` on the host);
    imports cv2 when called."""
    import cv2

    rng = rng or np.random.default_rng()
    assert img1.shape == img2.shape
    h1, w1 = img1.shape[:2]
    if w1 <= crop_size or h1 <= crop_size:
        img1 = _resize_shorter_cv2(img1, crop_size + 10)
        img2 = _resize_shorter_cv2(img2, crop_size + 10)
        h1, w1 = img1.shape[:2]
    x0 = int(rng.integers(0, w1 - crop_size))
    y0 = int(rng.integers(0, h1 - crop_size))
    img1 = img1[y0 : y0 + crop_size, x0 : x0 + crop_size]
    img2 = img2[y0 : y0 + crop_size, x0 : x0 + crop_size]

    h, w = img1.shape[:2]
    da = int(w * deformation_ratio)
    H_1t, img1 = _four_point_warp_cv2(rng, da, w, h, img1, bi=True)
    H_2t, img2 = _four_point_warp_cv2(rng, da, w, h, img2, bi=bi)
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
        img1 = _resize_cv2(img1, input_hw)
        img2 = _resize_cv2(img2, input_hw)
        # ref applies the h-ratio on the left and w-ratio on the right
        # (`generate_random_H_large_size.py:77-79`); square frames in practice
        S_l = np.diag([hi / hc, hi / hc, 1.0]).astype(np.float32)
        S_r = np.diag([wi / wc, wi / wc, 1.0]).astype(np.float32)
        H_s2t = S_l @ H_s2t @ np.linalg.inv(S_r)

    return img1, img2, H_s2t  # source, target, H source→target
