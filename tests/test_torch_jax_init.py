"""`gfnet_tpu_torch/utils/jax_init.py` and `utils/jax_random.py` against
`jax.random` and Flax: the ViT, the head, and the draws the sampler and
RANSAC make.

Keys, random bits and uniforms must equal JAX's bit for bit. Normal and
truncated-normal values go through erf_inv, whose `log1p` XLA evaluates its
own way: they must lie within `NORMAL_ULPS` units in the last place of JAX's.
Each random leaf of the ViT is checked twice: its key, by drawing the leaf
with JAX's own initializer from the key `vit_draws` derived, which must give
JAX's leaf exactly; and its numpy value, within `NORMAL_ULPS`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import _fold_in_static

from gfnet_tpu.config import DinoConfig as JDinoConfig
from gfnet_tpu.config import tiny_test_config as jax_tiny_config
from gfnet_tpu.matcher.api import GFNetMatcher as JGFNetMatcher
from gfnet_tpu.models.vit import VisionTransformer as JVisionTransformer
from gfnet_tpu_torch.config import DinoConfig, tiny_test_config
from gfnet_tpu_torch.matcher import GFNetMatcher
from gfnet_tpu_torch.utils import jax_init as ji
from gfnet_tpu_torch.utils import jax_random as jr
from gfnet_tpu_torch.utils.convert import flax_to_torch_head as convert_head
from gfnet_tpu_torch.utils.convert import flax_to_torch_vit


def ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_threefry_is_partitionable_here():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_keys_split_and_fold_in_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(ji.prng_key(seed), np.asarray(key))
    np.testing.assert_array_equal(ji.split(ji.prng_key(seed), 5), np.asarray(jax.random.split(key, 5)))
    for data in (0, 1, 123456789, 2**32 - 1):
        np.testing.assert_array_equal(ji.fold_in(ji.prng_key(seed), data),
                                      np.asarray(jax.random.fold_in(key, data)))


def test_flax_path_fold_in_equals_flax():
    key = jax.random.PRNGKey(3)
    for path in (("patch_embed", 1), (2,), ("blocks", "block", "attn", "qkv", 3), (300,), ()):
        np.testing.assert_array_equal(ji.fold_in_path(ji.prng_key(3), path),
                                      np.asarray(_fold_in_static(key, path)))


@pytest.mark.parametrize("shape", [(7,), (3, 1000), (2, 3, 40000)])
def test_random_bits_and_uniform_equal_jax_bit_for_bit(shape):
    key = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(ji.random_bits(ji.prng_key(11), shape),
                                  np.asarray(jax.random.bits(key, shape)))
    for lo, hi in ((0.0, 1.0), (-0.3, 2.0), (-0.9544997, 0.9544997)):
        got = ji.uniform(ji.prng_key(11), shape, lo, hi)
        want = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_normal_and_truncated_normal_within_the_stated_ulps():
    key = jax.random.PRNGKey(5)
    n = 1_500_000  # enough tail draws (|u| near 1) for erf_inv's far branch
    got, want = ji.normal(ji.prng_key(5), (n,)), np.asarray(jax.random.normal(key, (n,)))
    assert ulps(got, want).max() <= ji.NORMAL_ULPS
    assert np.abs(want).max() > 4.5
    got = ji.truncated_normal(ji.prng_key(5), -2.0, 2.0, (n,))
    want = np.asarray(jax.random.truncated_normal(key, -2.0, 2.0, (n,)))
    assert ulps(got, want).max() <= ji.NORMAL_ULPS
    assert got.min() > -2.0 and got.max() < 2.0


@functools.lru_cache(maxsize=None)
def _jax_initializer(init: str, shape: tuple, stddev):
    """JAX's initializer for one leaf, jitted as Flax's init is (XLA then
    fuses the multiply-adds the same way), compiled once per shape."""
    fn = jax.nn.initializers.lecun_normal() if init == "lecun_normal" else jax.nn.initializers.normal(stddev)
    return jax.jit(lambda k: fn(k, shape, jnp.float32))


def _jax_leaf(draw: ji.Draw) -> np.ndarray:
    return np.asarray(_jax_initializer(draw.init, draw.shape, draw.stddev)(jnp.asarray(draw.key)))


def _jax_vit(jcfg, seed):
    kv = jax.random.split(jax.random.PRNGKey(seed))[0]
    p = jcfg.patch_size
    return jax.jit(JVisionTransformer(jcfg, dtype=jnp.float32).init)(kv, jnp.zeros((2, 2 * p, 2 * p, 3)))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("kw", [
    dict(depth=2),  # full width: the real shapes, fan-ins and paths
    dict(d_model=64, depth=24, num_heads=4, pos_embed_size=6),  # the scan's split over 24
    dict(d_model=48, depth=2, num_heads=4, pos_embed_size=6, ffn_layer="swiglufused"),
], ids=["full_width_depth2", "narrow_depth24", "swiglu"])
def test_vit_params_equal_jax_init_for_every_leaf(kw):
    cfg, jcfg = DinoConfig(**kw), JDinoConfig(**kw)
    want = _jax_vit(jcfg, 0)["params"]
    got = ji.jax_vit_params(cfg, 0)["params"]
    want_leaves = {jax.tree_util.keystr(p): np.asarray(v)
                   for p, v in jax.tree_util.tree_leaves_with_path(want)}
    got_leaves = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(got)}
    assert sorted(got_leaves) == sorted(want_leaves)
    draws = ji.vit_draws(cfg, 0)
    random_paths = {jax.tree_util.keystr(tuple(jax.tree_util.DictKey(k) for k in d.path)) for d in draws}
    assert len(random_paths) == 7
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, path
        if path in random_paths:
            assert ulps(g, w).max() <= ji.NORMAL_ULPS, path
            assert w.std() > 0, path
        else:  # zeros, ones, LayerScale's init value
            np.testing.assert_array_equal(g, w, err_msg=path)
    # the key of every draw is JAX's: JAX's initializer on it gives JAX's leaf
    for d in draws:
        w = _leaf(want, d.path)
        w = w if d.layer is None else w[d.layer]
        np.testing.assert_array_equal(_jax_leaf(d), w, err_msg=f"{d.path} layer {d.layer}")


@functools.lru_cache(maxsize=None)
def _jax_matcher(seed: int):
    """The JAX package's tiny float32 matcher for `seed` (built once per seed)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("GFNET_KV_NORM", raising=False)
        return JGFNetMatcher(jax_tiny_config(), seed=seed, dtype=jnp.float32)


def test_matcher_backbone_is_the_jax_matchers():
    """`GFNetMatcher(tiny, seed=0)`'s ViT is JAX's `GFNetMatcher(tiny, seed=0)`'s."""
    jm = _jax_matcher(0)
    want = flax_to_torch_vit(jax.tree_util.tree_map(np.asarray, jm.vit_params))
    got = GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32, seed=0).vit.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert ulps(got[k].numpy(), w.numpy()).max() <= ji.NORMAL_ULPS, k
    # another seed draws another backbone
    other = GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32, seed=1).vit.state_dict()
    assert not torch.equal(other["blocks.0.attn.qkv.weight"], got["blocks.0.attn.qkv.weight"])



# ------------------------------------------------------------------ the head
def _jax_head_vars(seed: int):
    return _jax_matcher(seed).head_vars


@functools.lru_cache(maxsize=None)
def _jax_uniform(shape: tuple):
    return jax.jit(lambda k, bound: jax.random.uniform(k, shape, jnp.float32, -bound, bound))


@pytest.mark.parametrize("seed", [0, 1])
def test_head_params_equal_jax_matchers_head_for_every_leaf(seed):
    """`jax_head_params(tiny, seed)` is `GFNetMatcher(tiny, seed=seed).head_vars`:
    the same leaves, convolution kernels (uniforms) and constants bit for bit,
    Dense kernels (truncated normals) within `NORMAL_ULPS`; and the port's
    matcher built from the seed alone holds that head."""
    head_vars = _jax_head_vars(seed)
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(head_vars)}
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_leaves_with_path(ji.jax_head_params(tiny_test_config(), seed))}
    assert sorted(got) == sorted(want) and len(want) > 200
    draws = ji.head_draws(tiny_test_config(), seed)
    normals = {jax.tree_util.keystr(tuple(jax.tree_util.DictKey(k) for k in ("params", *d.path)))
               for d in draws if d.init == "lecun_normal"}
    assert len(normals) == 7  # the cross-view decoder's Dense kernels
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, path
        if path in normals:
            assert ulps(g, w).max() <= ji.NORMAL_ULPS and w.std() > 0, path
        else:
            np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32), err_msg=path)
    state = GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32, seed=seed).head.state_dict()
    bridged = convert_head(head_vars)
    assert sorted(state) == sorted(bridged)
    for k, w in bridged.items():
        assert ulps(state[k].numpy(), w.numpy()).max() <= ji.NORMAL_ULPS, k


def test_head_draw_keys_are_jaxs():
    """JAX's own initializers on the keys `head_draws` derives give JAX's
    leaves exactly, the scanned hidden blocks' per-layer keys included."""
    params = _jax_head_vars(0)["params"]
    for d in ji.head_draws(tiny_test_config(), 0):
        w = _leaf(params, d.path)
        w = w if d.layer is None else w[d.layer]
        got = (_jax_leaf(d) if d.init == "lecun_normal"
               else np.asarray(_jax_uniform(d.shape)(jnp.asarray(d.key), np.float32(d.bound))))
        np.testing.assert_array_equal(got, w, err_msg=f"{d.path} layer {d.layer}")


# ------------------------------------------------------------------- randint
@pytest.mark.parametrize("n", [1, 3, 7, 300, 4096, 5000, 70000])
def test_randint_equals_jax_bit_for_bit(n):
    for seed in (0, 9, 2**31 + 5):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(key, (512, 4), 0, n))
        np.testing.assert_array_equal(ji.randint(ji.prng_key(seed), (512, 4), 0, n), want)
        np.testing.assert_array_equal(jr.randint(ji.prng_key(seed), (512, 4), 0, n).numpy(), want)
    np.testing.assert_array_equal(ji.randint(ji.prng_key(3), (9,), 5, 12),
                                  np.asarray(jax.random.randint(jax.random.PRNGKey(3), (9,), 5, 12)))


@pytest.mark.parametrize("shape", [(7,), (3, 1000), (204800,)])
def test_device_draws_equal_numpy_and_jax_bit_for_bit(shape):
    """The torch draws (`utils/jax_random.py`, here on the CPU) against their
    numpy plain version and `jax.random`: bits and uniforms, one key and
    several segments hashed in one pass."""
    key = ji.prng_key(21)
    np.testing.assert_array_equal(jr.random_bits(key, shape, "cpu").numpy().astype(np.uint32),
                                  ji.random_bits(key, shape))
    for lo, hi in ((0.0, 1.0), (1e-20, 1.0), (-0.3, 2.0)):
        got = jr.uniform(key, shape, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(21), shape, jnp.float32, lo, hi))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    keys = ji.split(key, 3)
    words = jr.draw_words(keys, [5, 0, 11], "cpu").numpy().astype(np.uint32)
    np.testing.assert_array_equal(words, np.concatenate([ji.random_bits(keys[0], (5,)),
                                                         ji.random_bits(keys[2], (11,))]))
