"""The port's slice end to end against the JAX package at `tiny_test_config()`,
float32 on the CPU: `match()` (both passes, attenuation, stitch), the
threshold-balanced sampler fed the JAX-drawn Gumbel uniforms, and the solve
fed the JAX-drawn uniforms and RANSAC indices.

The JAX side runs with GFNET_S2D=0 (its space-to-depth stack is a TPU
lowering of the same math), GFNET_EXACT_TOPK=1 (exact top-k, not the TPU's
approx_max_k) and no GFNET_KV_NORM. The early-zero rule (rel < 1e-6 against
a 1e-7 seed displacement) never fires on these inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfnet_tpu.config import tiny_test_config as jax_tiny_config
from gfnet_tpu.matcher.api import GFNetMatcher as JGFNetMatcher
from gfnet_tpu.utils.convert import load_head_checkpoint
from gfnet_tpu_torch.config import tiny_test_config
from gfnet_tpu_torch.core.homography import corner_error
from gfnet_tpu_torch.matcher import GFNetMatcher
from gfnet_tpu_torch.utils.convert import flax_to_torch_vit, load_head_npz

HEAD = "workspace/trained_head_tiny.npz"


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def smooth_images(rng, b, h, w):
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img = np.zeros((b, h, w, 3), np.float32)
    for _ in range(8):
        f = rng.uniform(1, 6, (b, 1, 1, 3))
        ph = rng.uniform(0, 6.28, (b, 1, 1, 3))
        img += np.sin(2 * np.pi * f * (xx[None, ..., None] + 0.7 * yy[None, ..., None]) + ph)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


@pytest.fixture(scope="module")
def matchers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GFNET_S2D", "0")
        mp.setenv("GFNET_EXACT_TOPK", "1")
        mp.delenv("GFNET_KV_NORM", raising=False)
        jm = JGFNetMatcher(jax_tiny_config(), dtype=jnp.float32)
        jm.head_vars = load_head_checkpoint(HEAD, jm.head_vars)
        head_state, kv_norm = load_head_npz(HEAD)
        assert not kv_norm
        tm = GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32,
                          vit_state=flax_to_torch_vit(jm.vit_params), head_state=head_state)
        rng = np.random.default_rng(0)
        imA, imB = smooth_images(rng, 2, 100, 120), smooth_images(rng, 2, 100, 120)
        warp, cert = jm.match(imA, imB)
        yield jm, tm, imA, imB, np.asarray(warp), np.asarray(cert)


def test_match_matches_jax(matchers):
    _, tm, imA, imB, jwarp, jcert = matchers
    warp, cert = tm.match(imA, imB)
    assert warp.shape == jwarp.shape and cert.shape == jcert.shape
    # float32 through ViT, decoder, FPN and nine refiners on both sides
    np.testing.assert_allclose(warp.numpy(), jwarp, atol=2e-4)
    np.testing.assert_allclose(cert.numpy(), jcert, atol=2e-4)


def test_match_single_pair_drops_batch_axis(matchers):
    _, tm, imA, imB, jwarp, _ = matchers
    warp, cert = tm.match(imA[0], imB[0])
    assert warp.shape == jwarp.shape[1:] and cert.dim() == 2


def _jax_draws(key, n, num):
    """The uniforms `_sample_core` draws from `key` (two Gumbel draws)."""
    n_good = min(4 * num, n)
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (n,), minval=1e-20, maxval=1.0)
    u2 = jax.random.uniform(k2, (n_good,), minval=1e-20, maxval=1.0)
    return T(u1), T(u2)


@pytest.mark.parametrize("pair,num", [(0, 300), (1, 500)])
def test_sample_core_with_jax_uniforms(monkeypatch, matchers, pair, num):
    monkeypatch.setenv("GFNET_EXACT_TOPK", "1")
    jm, tm, _, _, jwarp, jcert = matchers
    m, c = jwarp[pair].reshape(-1, 4), jcert[pair].reshape(-1)
    key = jax.random.PRNGKey(7 + pair)
    jmatch, jc = jm._sample_core(jnp.asarray(m), jnp.asarray(c), num, key)
    tmatch, tc = tm._sample_core(T(m), T(c), num, *_jax_draws(key, len(c), num))
    np.testing.assert_allclose(tmatch.numpy(), np.asarray(jmatch), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)


def _homography_warp(rng, b, n, outliers=0.3):
    """(B, n, 4) normalized matches under known homographies, with noise and
    outliers, and certainties in [0, 1]: a well-posed solve."""
    warp = np.empty((b, n, 4), np.float32)
    for i in range(b):
        A = np.eye(3) + np.array([[0.05, 0.02, 0.1], [-0.03, 0.04, -0.05], [0.05, -0.04, 0.0]]) * rng.uniform(-1, 1)
        xa = rng.uniform(-0.9, 0.9, (n, 2))
        xb = xa @ A[:2, :2].T + A[:2, 2]
        xb = xb / (xa @ A[2, :2] + 1.0)[:, None]
        xb += rng.normal(0, 0.002, xb.shape)
        k = int(outliers * n)
        xb[:k] = rng.uniform(-1, 1, (k, 2))
        warp[i] = np.concatenate([xa, xb], -1)
    return warp, rng.uniform(0, 1, (b, n)).astype(np.float32)


def test_sample_solve_with_jax_draws(monkeypatch, matchers):
    """The batched sample + solve, fed per pair the uniforms and RANSAC
    indices that the JAX batched path draws from its keys, gives the JAX
    homographies."""
    monkeypatch.setenv("GFNET_EXACT_TOPK", "1")
    jm, tm, *_ = matchers
    num, key, hw_a, hw_b = 300, jax.random.PRNGKey(3), (100, 120), (90, 110)
    warp, cert = _homography_warp(np.random.default_rng(9), 2, 2000)
    H_jax = jm._sample_solve_batched_jit(jnp.asarray(warp), jnp.asarray(cert), num, key, hw_a, hw_b)
    draws = []
    for k in jax.random.split(key, 2):
        k1, k2 = jax.random.split(k)
        idx = jax.random.randint(k2, (512, 4), 0, num)
        draws.append((*_jax_draws(k1, warp.shape[1], num), torch.from_numpy(np.array(idx))))
    H = tm._sample_solve(T(warp), T(cert), num, hw_a, hw_b, [torch.stack(d) for d in zip(*draws)])
    for b in range(2):
        assert float(corner_error(H[b], T(H_jax[b]), 120.0, 100.0)) < 1e-2


def test_estimate_homography_batched_runs_and_single_is_first_pair(matchers):
    _, tm, imA, imB, _, _ = matchers
    key = np.asarray(jax.random.PRNGKey(0))
    Hs = tm.estimate_homography_batched(imA, imB, num_matches=300, key=key)
    assert Hs.shape == (2, 3, 3) and torch.isfinite(Hs).all()
    torch.testing.assert_close(Hs[:, 2, 2], torch.ones(2), atol=1e-5, rtol=0)
    # pair i draws from split(key, B)[i], the single pair from split(key, 1)[0]:
    # under partitionable threefry both are hash(key, (0, 0)) for the first pair
    H = tm.estimate_homography(imA[0], imB[0], num_matches=300, key=key)
    torch.testing.assert_close(H, Hs[0], atol=1e-4, rtol=1e-4)
