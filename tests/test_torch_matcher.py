"""The port's slice end to end against the JAX package at `tiny_test_config()`,
float32 on the CPU: `match()` (both passes, attenuation, stitch), the
threshold-balanced sampler fed the JAX-drawn Gumbel uniforms, and the solve
fed the JAX-drawn uniforms and RANSAC indices.

The JAX side runs with GFNET_S2D=0 (its space-to-depth stack is a TPU
lowering of the same math), GFNET_EXACT_TOPK=1 (exact top-k, not the TPU's
approx_max_k) and no GFNET_KV_NORM. The early-zero rule (rel < 1e-6 against
a 1e-7 seed displacement) never fires on these inputs.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfnet_tpu.config import tiny_test_config as jax_tiny_config
from gfnet_tpu.matcher.api import GFNetMatcher as JGFNetMatcher
from gfnet_tpu.utils.convert import load_head_checkpoint
from gfnet_tpu_torch.config import ModelConfig, tiny_test_config
from gfnet_tpu_torch.core.homography import corner_error
from gfnet_tpu_torch.matcher import GFNetMatcher
from gfnet_tpu_torch.utils.convert import flax_to_torch_vit, load_head, load_head_npz
from torch_cpu import one_thread  # noqa: F401

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


def _conf_json(path, kv_norm: bool) -> str:
    """A reference-format config JSON of the tiny config, k/v standardization
    on or off in its decoder."""
    cfg = tiny_test_config()
    dec = cfg.dino.decoder_cfg
    conf = {"dino_cfg": {"d_model": cfg.dino.d_model, "depth": cfg.dino.depth,
                         "num_heads": cfg.dino.num_heads, "pos_embed_size": cfg.dino.pos_embed_size,
                         "decoder_cfg": {"num_cross_attn": dec.num_cross_attn, "nhead": dec.nhead,
                                         "train_avg_length": dec.train_avg_length,
                                         "kv_norm": kv_norm}},
            "encoder_cfg": {"feat_chs": list(cfg.encoder.feat_chs)},
            "matcher": {"num_grid": list(cfg.matcher.num_grid), "radius": list(cfg.matcher.radius),
                        "displacement_dim": list(cfg.matcher.displacement_dim)},
            "initial_res": list(cfg.initial_res), "upsample_res": list(cfg.upsample_res)}
    path.write_text(json.dumps(conf))
    assert ModelConfig.from_json(path) == cfg.with_kv_norm(kv_norm)
    return str(path)


def test_config_kv_norm_survives_a_pth_head(matchers, tmp_path, monkeypatch):
    """A config with `kv_norm: true` and a `.pth` head (which says nothing of
    k/v standardization): `from_pretrained` and `cli.test` keep it on, as
    the JAX package keeps `GFNET_KV_NORM=1` on, and `match()` equals JAX's
    under `GFNET_KV_NORM=1` with the same head."""
    jm, tm, imA, imB, jwarp, _ = matchers
    pth = tmp_path / "head.pth"
    torch.save(tm.head.state_dict(), pth)
    conf = _conf_json(tmp_path / "tiny_kv.json", kv_norm=True)
    port = GFNetMatcher.from_pretrained(conf, str(pth), device="cpu", dtype=torch.float32,
                                        vit_state=tm.vit.state_dict())
    assert port.cfg.dino.decoder_cfg.kv_norm

    # cli.test's config path: the matcher it builds gets the config's flag
    import gfnet_tpu_torch.matcher.api as api
    from gfnet_tpu_torch.cli import test as cli_test

    class Built(Exception):
        pass

    def capture(cfg, **kw):
        raise Built(cfg)

    monkeypatch.setattr(api, "GFNetMatcher", capture)
    with pytest.raises(Built) as built:
        cli_test.main(["--conf_path", conf, "--ckpt_path", str(pth), "--dataset", "synthetic_tiny",
                       "--dinov2_weights", str(tmp_path / "none.pth"), "--device", "cpu"])
    assert built.value.args[0].dino.decoder_cfg.kv_norm
    monkeypatch.undo()

    # JAX with GFNET_KV_NORM=1 and the same head: a copy of the fixture's
    # matcher is a new static `self`, so its passes trace anew under the variable
    monkeypatch.setenv("GFNET_S2D", "0")
    monkeypatch.setenv("GFNET_EXACT_TOPK", "1")
    monkeypatch.setenv("GFNET_KV_NORM", "1")
    jm_kv = copy.copy(jm)
    jm_kv.head_vars = load_head_checkpoint(str(pth), jm.head_vars)
    want, want_cert = (np.asarray(a) for a in jm_kv.match(imA, imB))
    monkeypatch.delenv("GFNET_KV_NORM")
    assert np.abs(want - jwarp).max() > 1e-2  # k/v standardization moves the warp
    warp, cert = port.match(imA, imB)
    np.testing.assert_allclose(warp.numpy(), want, atol=2e-4)
    np.testing.assert_allclose(cert.numpy(), want_cert, atol=2e-4)


def test_orbax_head_matches_jax_load_head_checkpoint(matchers, tmp_path):
    """`load_head(<orbax dir>)` → the port's `match()` equals the JAX
    matcher with `load_head_checkpoint(<the same dir>)` (tiny, float32)."""
    import orbax.checkpoint as ocp

    jm, tm, imA, imB, _, _ = matchers
    tree: dict = {}
    with np.load(HEAD) as raw:
        for name in raw.files:
            d = tree
            *parents, leaf = name.split("/")
            for k in parents:
                d = d.setdefault(k, {})
            d[leaf] = jnp.asarray(raw[name])
    path = tmp_path / "tiny_head"
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree)
    ckptr.wait_until_finished()
    saved = jm.head_vars  # an argument of the compiled passes: swapping it traces nothing anew
    try:
        jm.head_vars = load_head_checkpoint(str(path), jm.head_vars)
        want, want_cert = (np.asarray(a) for a in jm.match(imA, imB))
    finally:
        jm.head_vars = saved
    head, kv_norm = load_head(str(path))
    assert kv_norm is None
    port = GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32,
                        vit_state=tm.vit.state_dict(), head_state=head)
    warp, cert = port.match(imA, imB)
    np.testing.assert_allclose(warp.numpy(), want, atol=2e-4)
    np.testing.assert_allclose(cert.numpy(), want_cert, atol=2e-4)
