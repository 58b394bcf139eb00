"""Match visualization (ref `estimation.py:93-117`'s kornia/matplotlib plot).

Counterpart of `gfnet_tpu/eval/visualize.py`: draws a subset of sampled
correspondences between the two images side by side, colored by inlier
status against a GT homography when given. numpy + matplotlib, which is
imported when a plot is drawn.
"""

from __future__ import annotations

import numpy as np


def one_way_transfer_error(pos_a: np.ndarray, pos_b: np.ndarray, H: np.ndarray) -> np.ndarray:
    ph = np.concatenate([pos_a, np.ones_like(pos_a[:, :1])], axis=-1)
    proj = ph @ H.T
    proj = proj[:, :2] / proj[:, 2:]
    return np.linalg.norm(proj - pos_b, axis=-1)


def draw_matches(
    im_a: np.ndarray,
    im_b: np.ndarray,
    pos_a: np.ndarray,
    pos_b: np.ndarray,
    H_gt: np.ndarray | None = None,
    num_draw: int = 50,
    inlier_thresh: float = 3.0,
    out_path: str = "match.png",
    seed: int = 0,
) -> str:
    """Save a side-by-side match plot; returns the output path.

    pos_a/pos_b: (N, 2) pixel coords in each image's frame. Raises
    RuntimeError where matplotlib is not installed.
    """
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("drawing the matches needs matplotlib, which is not installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(seed)
    n = len(pos_a)
    pick = rng.permutation(n)[: min(num_draw, n)]
    pa, pb = np.asarray(pos_a)[pick], np.asarray(pos_b)[pick]

    if H_gt is not None:
        err = one_way_transfer_error(pa, pb, np.asarray(H_gt))
        colors = np.where(err < inlier_thresh, "limegreen", "red")
    else:
        colors = np.array(["deepskyblue"] * len(pa))

    im_a = np.asarray(im_a)
    im_b = np.asarray(im_b)
    ha, wa = im_a.shape[:2]
    hb, wb = im_b.shape[:2]
    h = max(ha, hb)
    canvas = np.zeros((h, wa + wb, 3), dtype=np.float32)
    canvas[:ha, :wa] = im_a[..., :3]
    canvas[:hb, wa:] = im_b[..., :3]

    fig, ax = plt.subplots(figsize=(12, 6))
    ax.imshow(np.clip(canvas, 0, 1))
    for (xa, ya), (xb, yb), c in zip(pa, pb, colors):
        ax.plot([xa, xb + wa], [ya, yb], color=c, linewidth=0.6, alpha=0.8)
        ax.scatter([xa, xb + wa], [ya, yb], s=3, color=c)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path
