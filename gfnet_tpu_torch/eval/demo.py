"""Single-pair demo: match → sample → solve → metrics → visualization.

Counterpart of `gfnet_tpu/eval/demo.py`, the user-facing
`demo_estimation` (ref `estimation.py:46-118`): takes two image paths (or
arrays) + optional GT homography json, reports the corner error + runtime,
and optionally renders a `match.png`. Image files are read without PIL
(`data/imageio`); drawing needs matplotlib, and raises where it is missing.
"""

from __future__ import annotations

import json
import time

import numpy as np

from gfnet_tpu_torch.core.geometry import denormalize_corner_aligned
from gfnet_tpu_torch.core.homography import ransac_homography
from gfnet_tpu_torch.data.imageio import read_image
from gfnet_tpu_torch.eval.benchmark import homography_to_host, corner_error_np, unit_image
from gfnet_tpu_torch.utils import jax_init


def _load_image(img) -> np.ndarray:
    """An image path (JPEG or PNG, `data/imageio`) or array → (H, W, 3)
    float32 in [0, 1]."""
    if isinstance(img, str):
        return read_image(img).astype(np.float32) / 255.0
    return unit_image(img).cpu().numpy()


def demo_estimation(
    matcher,
    img1,
    img2,
    H_s2t_path: str | np.ndarray | None = None,
    num_matches: int = 5000,
    visualize: bool = False,
    out_path: str = "match.png",
    seed: int = 0,
):
    """Returns (corner_error_or_None, runtime_seconds, H_pred). The sampling
    and RANSAC draws take the keys of `split(PRNGKey(seed))`, as the JAX
    package's demo does."""
    im1 = _load_image(img1)
    im2 = _load_image(img2)
    h1, w1 = im1.shape[:2]
    h2, w2 = im2.shape[:2]

    H_gt = None
    if H_s2t_path is not None:
        if isinstance(H_s2t_path, str):
            with open(H_s2t_path) as f:
                H_gt = np.asarray(json.load(f)["H"], np.float64)
        else:
            H_gt = np.asarray(H_s2t_path, np.float64)

    k1, k2 = jax_init.split(jax_init.prng_key(seed))
    start = time.perf_counter()
    warp, certainty = matcher.match(im1, im2)
    matches, _ = matcher.sample(warp, certainty, num_matches, key=k1)
    pos_a = denormalize_corner_aligned(matches[:, :2], h1, w1)
    pos_b = denormalize_corner_aligned(matches[:, 2:], h2, w2)
    H_pred, _ = ransac_homography(pos_a, pos_b, key=k2)
    H_pred = homography_to_host(H_pred)
    runtime = time.perf_counter() - start

    err = None
    if H_gt is not None:
        err = corner_error_np(H_pred, H_gt, w1, h1)
        print(f"ACE is {err}.")

    if visualize:
        from gfnet_tpu_torch.eval.visualize import draw_matches

        path = draw_matches(im1, im2, pos_a.cpu().numpy(), pos_b.cpu().numpy(), H_gt,
                            out_path=out_path)
        print(f"The matching result is saved to {path}.")
    return err, runtime, H_pred
