"""The JAX package's random weights and draws, repeated in numpy bit for bit.

`gfnet_tpu.matcher.api.GFNetMatcher(cfg, seed=s)` draws its weights with
`init_params(jax.random.PRNGKey(s))`: `kv, kh = split(key)`, then
`VisionTransformer.init(kv, ...)` for the frozen ViT and
`GFNet.init(kh, ...)` for the head. Each draw there is a deterministic
computation, repeated here without JAX:

  - threefry2x32 (`jax/_src/prng.py`) in the partitionable layout (JAX's
    default, `jax_threefry_partitionable`): `split(key, n)[i]` and
    `fold_in(key, i)` hash the counter (0, i), and the bits of a draw of
    shape S are hash(key, (0, flat index)) with its two words xor-ed;
  - `uniform`: the top 23 bits as the mantissa of a float in [1, 2), minus 1,
    scaled and shifted in float32; `normal`: sqrt(2)·erf_inv(u) for u
    uniform in (-1, 1); `truncated_normal`: the same between erf(lower/√2)
    and erf(upper/√2), clipped to the open interval;
  - Flax's keys (`flax.core.scope`): a parameter's key folds the SHA-1 of
    its scope path and the scope's call counter into the module's key
    (`_fold_in_static`); `nn.scan` with `split_rngs={"params": True}`
    splits the raw key under the scan into one key a layer and keeps the
    path folded in after it, with the counters of the body's second trace;
  - `lecun_normal`: truncated normal on (-2, 2) times
    sqrt(1/fan_in) / 0.87962566, fan_in = in_features × receptive field;
    the head's convolutions take `torch_uniform_init`, a uniform on
    ±1/sqrt(fan_in) (`gfnet_tpu/models/common.py:18-30`);
  - `randint`: two bit draws from `split(key)`, the high and the low word of
    a 64-bit value reduced modulo the span (`jax._src.random._randint`).

The sampler and RANSAC draw on the matcher's device with the same
arithmetic (`utils/jax_random.py`); this file is their plain version.

Integer bits and uniforms equal JAX's exactly. XLA computes erf_inv from
Giles' single-precision polynomial after a `log1p` of its own; this file
evaluates the same polynomial with fused multiply-adds after numpy's
`log1p`, so normal and truncated-normal values may differ from JAX's by a
few units in the last place (`NORMAL_ULPS`; see
`tests/test_torch_jax_init.py`).

Work runs on the host in chunks of `CHUNK` values on a pool of threads
(numpy releases the interpreter lock), so host memory stays near the size of
the result (1.2 GB for ViT-L).
"""

from __future__ import annotations

import hashlib
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np

CHUNK = 1 << 19
# the most units in the last place a normal or truncated-normal value drawn
# here differs from JAX's (its erf_inv's log1p is XLA's own)
NORMAL_ULPS = 4
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32 = np.float32
# Giles, "Approximating the erfinv function" (GPU Computing Gems 2), single
# precision, as XLA/StableHLO's erf_inv evaluates it
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


# ------------------------------------------------------------ threefry keys
def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1),
    uint32 arrays of one shape, under `key` (2,) uint32."""
    k0, k1 = (np.full(1, int(k), np.uint32) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    t = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, r, out=t)
            x1 >>= 32 - r
            x1 |= t
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`: the 64-bit seed as (high, low) words."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)` → (num, 2) keys: the hash of (0, i)."""
    y0, y1 = threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)` for a uint32 `data`."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32), np.full(1, data, np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def fold_in_path(key, path: tuple) -> np.ndarray:
    """Flax's `_fold_in_static`: fold the first 4 bytes of the SHA-1 of the
    path's parts (strings as UTF-8, ints big-endian in their fewest bytes)
    into `key`."""
    if not path:
        return np.asarray(key, np.uint32)
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode() if isinstance(x, str) else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def _bits(key, start: int, stop: int) -> np.ndarray:
    """The 32-bit random words of flat indices [start, stop) of a draw."""
    y0, y1 = threefry2x32(key, np.zeros(stop - start, np.uint32),
                          np.arange(start, stop, dtype=np.uint32))
    y0 ^= y1
    return y0


def random_bits(key, shape) -> np.ndarray:
    """`jax.random.bits(key, shape, uint32)`."""
    return _draw(key, shape, lambda b: b, np.uint32)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(key, shape, minval, maxval)` in int32: the high
    and the low words from `split(key)`, each reduced modulo the span, joined
    by 2**32 mod span in uint32 arithmetic. maxval <= minval gives minval."""
    if not (-(1 << 31) <= minval and maxval < 1 << 31):
        raise ValueError(f"randint bounds ({minval}, {maxval}) are not int32")
    k_hi, k_lo = split(key)
    span = max(maxval - minval, 1)
    multiplier = (1 << 16) % span
    multiplier = multiplier * multiplier % (1 << 32) % span  # uint32 product, as JAX's
    hi = random_bits(k_hi, shape).astype(np.uint64) % np.uint64(span)
    lo = random_bits(k_lo, shape).astype(np.uint64) % np.uint64(span)
    offset = (hi * np.uint64(multiplier) % np.uint64(1 << 32) + lo) % np.uint64(1 << 32)
    return (offset % np.uint64(span)).astype(np.int64).astype(np.int32) + np.int32(minval)


# ------------------------------------------------------- float32 transforms
def _unit(bits: np.ndarray) -> np.ndarray:
    """Random words → float32 in [0, 1) by their top 23 bits."""
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(_F32) - _F32(1)


def _uniform_of(bits: np.ndarray, lo: np.float32, hi: np.float32) -> np.ndarray:
    """floats · (hi - lo) + lo as one fused multiply-add, as XLA contracts it."""
    u = (_unit(bits) * np.float64(hi - lo) + np.float64(lo)).astype(_F32)
    return np.maximum(lo, u)


def _horner_f32(w: np.ndarray, coeffs) -> np.ndarray:
    """Σ c_i w^(n-1-i) in float32, each step one fused multiply-add (a
    float64 product of two float32 values is exact)."""
    w64 = w.astype(np.float64)
    p = np.full(w.shape, coeffs[0], _F32)
    for c in coeffs[1:]:
        p = (p * w64 + float(_F32(c))).astype(_F32)
    return p


def erf_inv(x: np.ndarray) -> np.ndarray:
    """float32 erf⁻¹ by Giles' single-precision polynomial, as XLA's; ±1 → ±inf."""
    x = np.asarray(x, _F32)
    with np.errstate(divide="ignore"):
        w = -np.log1p(-(x * x))
    lt = w < _F32(5)
    p = _horner_f32(w - _F32(2.5), _ERFINV_W_LT_5)
    if not lt.all():
        far = ~lt
        p[far] = _horner_f32(np.sqrt(w[far]) - _F32(3), _ERFINV_W_GE_5)
    out = p * x
    edge = np.abs(x) == _F32(1)
    if edge.any():
        out[edge] = x[edge] * _F32(np.inf)
    return out


_SQRT2 = _F32(math.sqrt(2))


def _erf_f32(x: np.float32) -> np.float32:
    return _F32(math.erf(float(x)))


def _normal_of(bits: np.ndarray) -> np.ndarray:
    lo = np.nextafter(_F32(-1), _F32(0))
    return _SQRT2 * erf_inv(_uniform_of(bits, lo, _F32(1)))


def _truncated_normal_of(bits: np.ndarray, lower: float, upper: float) -> np.ndarray:
    lower, upper = _F32(lower), _F32(upper)
    a, b = _erf_f32(lower / _SQRT2), _erf_f32(upper / _SQRT2)
    out = _SQRT2 * erf_inv(_uniform_of(bits, a, b))
    return np.clip(out, np.nextafter(lower, _F32(np.inf)), np.nextafter(upper, _F32(-np.inf)))


def _draw(key, shape, transform, dtype=_F32, out: np.ndarray | None = None) -> np.ndarray:
    """transform(random words) for every flat index of `shape`, chunk by
    chunk on a thread pool, into `out` (a new array by default)."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"draws of 2**32 values or more are not supported: {shape}")
    if out is None:
        out = np.empty(shape, dtype)
    flat = out.reshape(-1)  # a view: `out` is C-contiguous

    def fill(start: int) -> None:
        stop = min(start + CHUNK, n)
        flat[start:stop] = transform(_bits(key, start, stop))

    starts = range(0, n, CHUNK)
    if len(starts) == 1:
        fill(0)
    else:
        with ThreadPoolExecutor(min(os.cpu_count() or 1, len(starts))) as pool:
            for f in [pool.submit(fill, s) for s in starts]:
                f.result()
    return out


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    return _draw(key, shape, lambda b: _uniform_of(b, _F32(minval), _F32(maxval)))


def normal(key, shape) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)`."""
    return _draw(key, shape, _normal_of)


def truncated_normal(key, lower: float, upper: float, shape) -> np.ndarray:
    """`jax.random.truncated_normal(key, lower, upper, shape, float32)`."""
    return _draw(key, shape, lambda b: _truncated_normal_of(b, lower, upper))


def lecun_normal(key, shape, out: np.ndarray | None = None) -> np.ndarray:
    """Flax's default kernel init, `jax.nn.initializers.lecun_normal()`:
    fan_in from axis -2 times the receptive field, float32 stddev."""
    fan_in = shape[-2] * (math.prod(shape) / shape[-2] / shape[-1])
    stddev = np.sqrt(_F32(1.0 / fan_in)) / _F32(0.87962566103423978)
    return _draw(key, shape, lambda b: _truncated_normal_of(b, -2.0, 2.0) * stddev, out=out)


def normal_init(key, shape, stddev: float) -> np.ndarray:
    """`jax.nn.initializers.normal(stddev)`."""
    s = _F32(stddev)
    return _draw(key, shape, lambda b: _normal_of(b) * s)


# ------------------------------------------------------------ the ViT tree
def _vit_dense_layers(cfg) -> dict:
    """The Dense kernels of one ViT block: Flax path under `block` → (in, out)."""
    d = cfg.d_model
    hidden = int(d * cfg.mlp_ratio)
    layers = {("attn", "qkv"): (d, 3 * d), ("attn", "proj"): (d, d)}
    if cfg.ffn_layer == "mlp":
        layers.update({("mlp", "fc1"): (d, hidden), ("mlp", "fc2"): (hidden, d)})
    elif cfg.ffn_layer in ("swiglu", "swiglufused"):
        hf = (int(hidden * 2 / 3) + 7) // 8 * 8
        layers.update({("mlp", "w12"): (d, 2 * hf), ("mlp", "w3"): (hf, d)})
    else:
        raise ValueError(f"unknown ffn_layer {cfg.ffn_layer!r}")
    return layers


class Draw(NamedTuple):
    """One random leaf (or one layer of a stacked leaf) of a JAX tree: its
    path in the tree, the layer along the stacked depth axis (None for an
    unstacked leaf), its key, and how it is drawn: "lecun_normal", "normal"
    with `stddev`, or "uniform" on ±`bound`."""

    path: tuple
    layer: int | None
    key: np.ndarray
    init: str
    shape: tuple
    stddev: float | None = None
    bound: float | None = None


def _value(draw: Draw, out: np.ndarray | None = None) -> np.ndarray:
    if draw.init == "lecun_normal":
        return lecun_normal(draw.key, draw.shape, out=out)
    if draw.init == "uniform":
        value = uniform(draw.key, draw.shape, -draw.bound, draw.bound)
    else:
        value = normal_init(draw.key, draw.shape, draw.stddev)
    if out is not None:
        out[...] = value
    return value


def vit_draws(cfg, seed: int = 0) -> list[Draw]:
    """Every random draw of the JAX package's
    `GFNetMatcher(ModelConfig(dino=cfg)).init_params(PRNGKey(seed))` ViT."""
    kv = split(prng_key(seed))[0]
    d, p = cfg.d_model, cfg.patch_size
    # a parameter folds in its scope path and its scope's call count: the
    # first parameter of a child scope (name, 1), the module's own 1, 2, ...
    draws = [Draw(("patch_embed", "kernel"), None, fold_in_path(kv, ("patch_embed", 1)),
                  "lecun_normal", (p, p, 3, d)),
             Draw(("cls_token",), None, fold_in_path(kv, (1,)), "normal", (1, 1, d), 1e-6),
             Draw(("pos_embed",), None, fold_in_path(kv, (2,)), "normal",
                  (1, cfg.pos_embed_size**2 + 1, d), 0.02)]
    # the scan splits the module's own key into one a layer and keeps the
    # path: a block kernel folds ("blocks", "block", ..., 3) into its layer's
    # key. Flax traces the body twice (once for the shapes of its variables)
    # and the counters run on: kernel 1, bias 2 in the first trace, kernel 3
    # in the one that draws.
    layer_keys = split(kv, cfg.depth)
    for (parent, name), shape in _vit_dense_layers(cfg).items():
        for i in range(cfg.depth):
            key = fold_in_path(layer_keys[i], ("blocks", "block", parent, name, 3))
            draws.append(Draw(("blocks", "block", parent, name, "kernel"), i, key,
                              "lecun_normal", shape))
    return draws


def jax_vit_params(cfg, seed: int = 0) -> dict:
    """The numpy tree that the JAX package's
    `GFNetMatcher(ModelConfig(dino=cfg)).init_params(PRNGKey(seed))[0]` returns:
    {"params": ...} with the blocks stacked along a leading depth axis, all
    float32. `cfg` is a `DinoConfig`."""
    d, depth = cfg.d_model, cfg.depth
    zeros = lambda *s: np.zeros(s, _F32)
    ones = lambda *s: np.ones(s, _F32)
    params = {"patch_embed": {"bias": zeros(d)}, "norm": {"scale": ones(d), "bias": zeros(d)}}
    block = {"norm1": {"scale": ones(depth, d), "bias": zeros(depth, d)},
             "norm2": {"scale": ones(depth, d), "bias": zeros(depth, d)},
             "ls1": {"gamma": np.full((depth, d), cfg.init_values, _F32)},
             "ls2": {"gamma": np.full((depth, d), cfg.init_values, _F32)},
             "attn": {}, "mlp": {}}
    for (parent, name), shape in _vit_dense_layers(cfg).items():
        block[parent][name] = {"kernel": np.empty((depth, *shape), _F32),
                               "bias": zeros(depth, shape[1])}
    params["blocks"] = {"block": block}
    _fill(params, vit_draws(cfg, seed))
    return {"params": params}


def _fill(tree: dict, draws: list[Draw]) -> None:
    """Put each draw's value at its path in `tree` (a stacked leaf there
    already, for a draw with a layer)."""
    for draw in draws:
        *parents, leaf = draw.path
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        if draw.layer is None:
            node[leaf] = _value(draw)
        else:
            _value(draw, out=node[leaf][draw.layer])


# ----------------------------------------------------------- the head tree
HIDDEN_BLOCKS, REFINE_KERNEL = 8, 5  # `gfnet_tpu/models/refiner.py` ConvRefiner defaults
SCALES = ("16", "8", "4", "2", "1")


class Leaf(NamedTuple):
    """One leaf of the JAX head's variables: its collection ("params" or
    "batch_stats"), its path, its shape (a scanned leaf's without the layer
    axis), the number of scanned layers (None: not scanned), and how it is
    made: "lecun_normal" (a Dense kernel), "uniform" (a convolution kernel,
    `torch_uniform_init`) or a constant fill."""

    collection: str
    path: tuple
    shape: tuple
    layers: int | None
    init: str | float


def _head_leaves(cfg) -> list[Leaf]:
    """Every leaf of `gfnet_tpu.models.gfnet.GFNet(cfg)`'s variables, in the
    modules' layout (`gfnet_tpu/models/{crossview,fpn,refiner}.py`)."""
    leaves: list[Leaf] = []
    add = lambda path, shape, init, layers=None, coll="params": leaves.append(
        Leaf(coll, path, tuple(shape), layers, init))

    def dense(path, i, o, bias=True):
        add(path + ("kernel",), (i, o), "lecun_normal")
        if bias:
            add(path + ("bias",), (o,), 0.0)

    def norm(path, c, layers=None, stats=False):
        add(path + ("scale",), (c,), 1.0, layers)
        add(path + ("bias",), (c,), 0.0, layers)
        if stats:
            add(path + ("mean",), (c,), 0.0, layers, "batch_stats")
            add(path + ("var",), (c,), 1.0, layers, "batch_stats")

    def conv(path, k, i, o, bias, layers=None):
        add(path + ("kernel",), (k, k, i, o), "uniform", layers)
        if bias:
            add(path + ("bias",), (o,), 0.0, layers)

    def conv_bn(path, k, i, o, bias):
        conv(path + ("conv",), k, i, o, bias)
        norm(path + ("bn",), o, stats=True)

    fd = tuple(cfg.encoder.feat_chs)  # coarse → fine
    dec = cfg.dino.decoder_cfg
    dim = fd[0]
    dense(("crossview", "proj"), cfg.dino.d_model, dim, bias=False)
    hidden = int(dim * dec.mlp_ratio)
    for i in range(dec.num_cross_attn):
        blk = ("crossview", f"cross{i}")
        for name in ("q_proj", "k_proj", "v_proj"):
            dense(blk + ("attn", name), dim, dim, bias=False)
        dense(blk + ("attn", "proj"), dim, dim)
        for name in ("ls1", "ls2"):
            add(blk + (name, "gamma"), (dim,), float(dec.init_values))
        for name in ("norm1", "norm2"):
            norm(blk + (name,), dim)
        if dec.ffn_type == "glu":
            dense(blk + ("mlp_w12",), dim, 2 * hidden)
            dense(blk + ("mlp_w3",), hidden, dim)
        else:
            dense(blk + ("mlp_fc1",), dim, hidden)
            dense(blk + ("mlp_fc2",), hidden, dim)
    c0, c1, c2, c3 = fd[::-1]  # fine → coarse
    for name, k, i, o in (("conv00", 7, 3, c0), ("conv01", 5, c0, c0), ("downsample1", 5, c0, c1),
                          ("conv10", 3, c1, c1), ("conv11", 3, c1, c1), ("downsample2", 5, c1, c2),
                          ("conv20", 3, c2, c2), ("conv21", 3, c2, c2), ("downsample3", 3, c2, c3),
                          ("conv30", 3, c3, c3), ("conv31", 3, c3, c3)):
        conv_bn(("encoder", name), k, i, o, bias=False)
    for name, k, i, o in (("out0", 1, c3, c3), ("inner1", 3, c3 + c2, c2), ("out1", 1, c2, c2),
                          ("inner2", 3, c2 + c1, c1), ("out2", 1, c1, c1),
                          ("inner3", 3, c1 + c0, c0), ("out3", 1, c0, c0)):
        conv_bn(("fpn_decoder", name), k, i, o, bias=True)
    conv_bn(("merge_layer",), 3, 2 * fd[0], fd[0], bias=True)
    feat_at_scale = {"16": fd[0], "8": fd[0], "4": fd[1], "2": fd[2], "1": fd[3]}
    for i, scale in enumerate(SCALES):
        r, disp = cfg.matcher.radius[i], cfg.matcher.displacement_dim[i]
        h = 2 * feat_at_scale[scale] + disp + ((2 * r + 1) ** 2 if r > 0 else 0)
        ref = (f"refiners_{scale}",)
        conv(ref + ("disp_emb",), 1, 2, disp, bias=True)
        for blk, layers in ((ref + ("block1",), None), (ref + ("hidden", "block"), HIDDEN_BLOCKS)):
            conv(blk + ("dw",), REFINE_KERNEL, 1, h, bias=True, layers=layers)
            norm(blk + ("bn",), h, layers, stats=True)
            conv(blk + ("pw",), 1, h, h, bias=True, layers=layers)
        conv(ref + ("out_conv",), 1, h, 3, bias=True)
    return leaves


def head_draws(cfg, seed: int = 0) -> list[Draw]:
    """Every random draw of the JAX package's
    `GFNetMatcher(cfg, seed=seed).init_params(PRNGKey(seed))` head, drawn by
    `GFNet.init(kh, ...)` with `kh = split(PRNGKey(seed))[1]`.

    Every random leaf is a kernel, the first parameter its scope makes, so
    its key folds in (scope path..., 1). The refiners' hidden blocks run
    under `nn.scan`, which splits `kh` itself into one key a layer and keeps
    the path folded in after it; Flax traces the scan body twice and the
    scope's counter runs on (kernel 1, bias 2, then kernel 3), as for the
    ViT's blocks (`vit_draws`)."""
    kh = split(prng_key(seed))[1]
    layer_keys = split(kh, HIDDEN_BLOCKS)
    draws = []
    for leaf in _head_leaves(cfg):
        if leaf.init not in ("lecun_normal", "uniform"):
            continue
        scope = leaf.path[:-1]
        fan_in = math.prod(leaf.shape[:-1])
        bound = float(1.0 / np.sqrt(fan_in)) if leaf.init == "uniform" else None
        if leaf.layers is None:
            draws.append(Draw(leaf.path, None, fold_in_path(kh, scope + (1,)), leaf.init, leaf.shape,
                              bound=bound))
        else:
            draws += [Draw(leaf.path, i, fold_in_path(layer_keys[i], scope + (3,)), leaf.init, leaf.shape,
                           bound=bound) for i in range(leaf.layers)]
    return draws


def jax_head_params(cfg, seed: int = 0) -> dict:
    """The numpy tree {"params": ..., "batch_stats": ...} that the JAX
    package's `GFNetMatcher(cfg, seed=seed).head_vars` holds, all float32,
    the hidden blocks stacked along a leading layer axis. `cfg` is a
    `ModelConfig`."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for leaf in _head_leaves(cfg):
        node = tree[leaf.collection]
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        shape = leaf.shape if leaf.layers is None else (leaf.layers, *leaf.shape)
        fill = 0.0 if isinstance(leaf.init, str) else leaf.init
        node[leaf.path[-1]] = np.full(shape, fill, _F32)
    _fill(tree["params"], head_draws(cfg, seed))
    return tree
