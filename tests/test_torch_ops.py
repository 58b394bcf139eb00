"""The port's plain ops (`gfnet_tpu_torch.core`, `gfnet_tpu_torch.ops`) against
the JAX package on the same numpy inputs, float32 on the CPU.

Tolerances: 1e-5..1e-4 absolute where both sides do the same float32
arithmetic in another summation order; looser ones say why beside them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfnet_tpu.core import geometry as jgeo
from gfnet_tpu.core import homography as jhom
from gfnet_tpu.ops import correlation as jcorr
from gfnet_tpu.ops.kde import kde as jax_kde
from gfnet_tpu.ops import resize as jres
from gfnet_tpu.ops import sampler as jsamp
from gfnet_tpu_torch.core import geometry as tgeo
from gfnet_tpu_torch.core import homography as thom
from gfnet_tpu_torch.ops import correlation as tcorr
from gfnet_tpu_torch.ops.kde import kde as torch_kde
from gfnet_tpu_torch.ops import resize as tres
from gfnet_tpu_torch.ops import sampler as tsamp


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _homography_pair(rng, n=300, w=200.0, h=160.0, outliers=0.3, noise=0.5):
    corners = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float32)
    moved = corners + rng.uniform(-20, 20, corners.shape).astype(np.float32)
    H = np.asarray(jgeo.get_perspective_transform(jnp.asarray(corners), jnp.asarray(moved)))
    src = rng.uniform([0, 0], [w, h], (n, 2)).astype(np.float32)
    dst = np.asarray(jgeo.transform_points(jnp.asarray(H), jnp.asarray(src)))
    dst = dst + rng.normal(0, noise, dst.shape).astype(np.float32)
    k = int(outliers * n)
    dst[:k] = rng.uniform([0, 0], [w, h], (k, 2)).astype(np.float32)
    return H, src, dst


@pytest.mark.parametrize("h,w", [(4, 4), (7, 5)])
def test_normalized_grid(h, w):
    np.testing.assert_allclose(N(tgeo.normalized_grid(h, w)), N(jgeo.normalized_grid(h, w)), atol=1e-7)


def test_denormalize_corner_aligned_and_transform_points():
    rng = np.random.default_rng(0)
    xn = rng.uniform(-1, 1, (3, 50, 2)).astype(np.float32)
    np.testing.assert_allclose(N(tgeo.denormalize_corner_aligned(T(xn), 120, 90)),
                               N(jgeo.denormalize_corner_aligned(jnp.asarray(xn), 120, 90)), atol=1e-5)
    H = np.eye(3, dtype=np.float32)[None].repeat(3, 0) + rng.normal(0, 0.05, (3, 3, 3)).astype(np.float32)
    pts = rng.uniform(0, 100, (3, 50, 2)).astype(np.float32)
    np.testing.assert_allclose(N(tgeo.transform_points(T(H), T(pts))),
                               N(jgeo.transform_points(jnp.asarray(H), jnp.asarray(pts))), rtol=1e-5, atol=1e-4)


def test_get_perspective_transform_batched():
    rng = np.random.default_rng(1)
    src = rng.uniform(0, 200, (16, 4, 2)).astype(np.float32)
    dst = src + rng.uniform(-15, 15, src.shape).astype(np.float32)
    got = N(tgeo.get_perspective_transform(T(src), T(dst)))
    want = N(jgeo.get_perspective_transform(jnp.asarray(src), jnp.asarray(dst)))
    # 8x8 solves in float32: conditioning-limited, ~1e-5 relative
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_get_perspective_transform_degenerate_is_not_finite():
    src = np.zeros((1, 4, 2), np.float32)  # four identical points: singular system
    got = N(tgeo.get_perspective_transform(T(src), T(src)))
    assert not np.isfinite(got).all()


def test_warp_perspective():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (2, 20, 24, 3)).astype(np.float32)
    H = np.eye(3, dtype=np.float32)[None].repeat(2, 0)
    H[:, :2, 2] = rng.uniform(-3, 3, (2, 2))
    H[:, 0, 1] = 0.05
    got = N(tgeo.warp_perspective(T(img), T(H), (18, 22)))
    want = N(jgeo.warp_perspective(jnp.asarray(img), jnp.asarray(H), (18, 22)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dlt_and_irls_match_jax():
    rng = np.random.default_rng(3)
    _, src, dst = _homography_pair(rng, outliers=0.0)
    w = rng.uniform(0.2, 1.0, len(src)).astype(np.float32)
    for fn in ("dlt_homography", "irls_homography"):
        got = N(getattr(thom, fn)(T(src), T(dst), T(w)))
        want = N(getattr(jhom, fn)(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
        np.testing.assert_allclose(got / got[2, 2], want / want[2, 2], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("seed", [4, 5])
def test_ransac_same_indices_as_jax(seed):
    """Both sides get the hypotheses `jax.random.randint(key, (512, 4), 0, n)` draws."""
    rng = np.random.default_rng(seed)
    H_true, src, dst = _homography_pair(rng)
    key = jax.random.PRNGKey(seed)
    idx = np.asarray(jax.random.randint(key, (512, 4), 0, len(src)))
    H_j, inl_j = jhom.ransac_homography(jnp.asarray(src), jnp.asarray(dst), key=key)
    H_t, inl_t = thom.ransac_homography_from_indices(T(src), T(dst), None, torch.from_numpy(idx.copy()))
    # the same best hypothesis gives the same inlier set; the refit then
    # agrees to float32 solve precision (corner error in pixels)
    assert (N(inl_t) != np.asarray(inl_j)).sum() <= 2
    ce = float(thom.corner_error(H_t, T(np.asarray(H_j)), 200.0, 160.0))
    assert ce < 1e-2
    assert float(thom.corner_error(H_t, T(H_true), 200.0, 160.0)) < 1.0


def test_ransac_generator_draw_and_corner_error():
    """RANSAC drawing its own hypotheses under a JAX key: the same indices as
    the JAX package's `randint(key, (512, 4), 0, N)`, so the same solve."""
    rng = np.random.default_rng(6)
    H_true, src, dst = _homography_pair(rng)
    key = jax.random.PRNGKey(4)
    H, inl = thom.ransac_homography(T(src), T(dst), key=np.asarray(key))
    H_j, inl_j = jhom.ransac_homography(jnp.asarray(src), jnp.asarray(dst), key=key)
    assert float(thom.corner_error(H, T(np.asarray(H_j)), 200.0, 160.0)) < 1e-2
    assert (N(inl) != np.asarray(inl_j)).sum() <= 2
    assert torch.isfinite(H).all() and float(H[2, 2]) == pytest.approx(1.0, abs=1e-6)
    ce_t = float(thom.corner_error(H, T(H_true), 200.0, 160.0))
    ce_j = float(jhom.corner_error(jnp.asarray(N(H)), jnp.asarray(H_true), 200.0, 160.0))
    assert ce_t == pytest.approx(ce_j, abs=1e-3) and ce_t < 1.0


def test_ransac_batched_equals_each_pair():
    """B pairs solved as one batch give each pair's own solve."""
    rng = np.random.default_rng(12)
    pairs = [_homography_pair(rng) for _ in range(3)]
    src = torch.stack([T(p[1]) for p in pairs])
    dst = torch.stack([T(p[2]) for p in pairs])
    idx = torch.randint(0, src.shape[1], (3, 512, 4), generator=torch.Generator().manual_seed(1))
    H, inl = thom.ransac_homography_from_indices(src, dst, None, idx)
    assert H.shape == (3, 3, 3) and inl.shape == src.shape[:2]
    for i in range(3):
        H_i, inl_i = thom.ransac_homography_from_indices(src[i], dst[i], None, idx[i])
        assert float(thom.corner_error(H[i], H_i, 200.0, 160.0)) < 1e-3
        assert (inl[i] != inl_i).sum() <= 2


@pytest.mark.parametrize("mode,antialias,src,dst", [
    ("bilinear", False, (17, 23), (40, 31)),
    ("bilinear", False, (40, 36), (12, 9)),
    ("bilinear", True, (40, 36), (12, 9)),
    ("bilinear", True, (12, 9), (30, 25)),
    ("bicubic", False, (17, 23), (40, 31)),
    ("bicubic", True, (40, 36), (12, 9)),
    ("bicubic", True, (100, 120), (112, 112)),
])
def test_interpolate_matches_jax(mode, antialias, src, dst):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, *src, 3)).astype(np.float32)
    got = N(tres.interpolate(T(x), dst, mode, False, antialias=antialias))
    want = N(jres.interpolate(jnp.asarray(x), dst, mode, False, antialias=antialias))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_interpolate_align_corners_and_pos_embed_scale():
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (1, 8, 8, 5)).astype(np.float32)
    np.testing.assert_allclose(N(tres.interpolate(T(x), (13, 11), "bilinear", True)),
                               N(jres.interpolate(jnp.asarray(x), (13, 11), "bilinear", True)), atol=1e-5)
    # the DINOv2 pos-embed path: explicit scale factor with the +0.1 offset
    scale = ((6 + 0.1) / 8, (7 + 0.1) / 8)
    np.testing.assert_allclose(N(tres.interpolate(T(x), (6, 7), "bicubic", False, scale=scale)),
                               N(jres.interpolate(jnp.asarray(x), (6, 7), "bicubic", False, scale=scale)),
                               atol=1e-5)


def test_grid_sample_matches_jax():
    rng = np.random.default_rng(9)
    img = rng.normal(0, 1, (2, 11, 13, 4)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 7, 9, 2)).astype(np.float32)
    np.testing.assert_allclose(N(tsamp.grid_sample(T(img), T(grid))),
                               N(jsamp.grid_sample(jnp.asarray(img), jnp.asarray(grid))), atol=1e-5)


def test_correlation_and_flow_init_match_jax():
    rng = np.random.default_rng(10)
    f0 = rng.normal(0, 1, (2, 6, 6, 16)).astype(np.float32)
    f1 = rng.normal(0, 1, (2, 6, 6, 16)).astype(np.float32)
    np.testing.assert_allclose(N(tcorr.global_correlation(T(f0), T(f1))),
                               N(jcorr.global_correlation(jnp.asarray(f0), jnp.asarray(f1))), atol=1e-4)
    np.testing.assert_allclose(N(tcorr.corr_volume_flow(T(f0), T(f1))),
                               N(jcorr.corr_volume_flow(jnp.asarray(f0), jnp.asarray(f1))), atol=1e-5)


@pytest.mark.parametrize("n,block", [(1000, 4096), (900, 256)])
def test_kde_matches_jax(n, block):
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    got = N(torch_kde(T(x), std=0.1, block=block))
    want = N(jax_kde(jnp.asarray(x), std=0.1, block=block))
    # exp(-50 d²) of a float32 cross term: ~1e-5 relative
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_kde_batched_equals_each_member():
    rng = np.random.default_rng(13)
    x = T(rng.uniform(-1, 1, (3, 700, 4)))
    got = torch_kde(x, std=0.1, block=512)  # 170 rows of each member per step
    for i in range(3):
        torch.testing.assert_close(got[i], torch_kde(x[i], std=0.1, block=512), rtol=1e-5, atol=1e-5)
