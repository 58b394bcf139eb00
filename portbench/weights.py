"""The weights both sides are handed: the frozen DINOv2 ViT and the head.

The ViT is the draw that `gfnet_tpu.matcher.api.GFNetMatcher(cfg, seed=0)`
makes with `init_params(jax.random.PRNGKey(0))`, repeated in numpy (the
trained head was trained on that backbone): threefry-2x32 keys folded along
Flax's scope paths, lecun-normal kernels, normal cls token and position
embedding. It is drawn once a checkout and kept in bf16, the type it is
served in, under `portbench/.cache/`, keyed by this file's hash and the
configuration. The head is read from its `.npz` (flat `params/...` and
`batch_stats/...` keys) and checked against the sha256 its configuration
records. Both come out as state dicts in the layout the port's modules and
the reference's share.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from portbench.reference.keys import fold_in, prng_key, split

CACHE = Path(__file__).resolve().parent / ".cache"
CHUNK = 1 << 19
_F32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = _F32(math.sqrt(2))


# ---------------------------------------------------------------- the draw
def _bits(key, start: int, stop: int) -> np.ndarray:
    """The words of flat indices [start, stop) of a draw under `key`
    (threefry-2x32 of (0, index), halves xor-ed), in place."""
    k0, k1 = (np.uint32(int(k)) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(_PARITY)))
    x0 = np.zeros(stop - start, np.uint32) + ks[0]
    x1 = np.arange(start, stop, dtype=np.uint32) + ks[1]
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
    x0 ^= x1
    return x0


def _uniform_of(bits: np.ndarray, lo: np.float32, hi: np.float32) -> np.ndarray:
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(_F32) - _F32(1)
    return np.maximum(lo, (u * np.float64(hi - lo) + np.float64(lo)).astype(_F32))


def _horner_f32(w: np.ndarray, coeffs) -> np.ndarray:
    w64 = w.astype(np.float64)
    p = np.full(w.shape, coeffs[0], _F32)
    for c in coeffs[1:]:
        p = (p * w64 + float(_F32(c))).astype(_F32)
    return p


def _erf_inv(x: np.ndarray) -> np.ndarray:
    """float32 erf⁻¹ by Giles' single-precision polynomial, as XLA's."""
    with np.errstate(divide="ignore"):
        w = -np.log1p(-(x * x))
    p = _horner_f32(w - _F32(2.5), _ERFINV_W_LT_5)
    far = w >= _F32(5)
    if far.any():
        p[far] = _horner_f32(np.sqrt(w[far]) - _F32(3), _ERFINV_W_GE_5)
    out = p * x
    edge = np.abs(x) == _F32(1)
    if edge.any():
        out[edge] = x[edge] * _F32(np.inf)
    return out


def _normal_of(bits: np.ndarray) -> np.ndarray:
    return _SQRT2 * _erf_inv(_uniform_of(bits, np.nextafter(_F32(-1), _F32(0)), _F32(1)))


def _truncated_normal_of(bits: np.ndarray, lower: float, upper: float) -> np.ndarray:
    lower, upper = _F32(lower), _F32(upper)
    a, b = _F32(math.erf(float(lower / _SQRT2))), _F32(math.erf(float(upper / _SQRT2)))
    out = _SQRT2 * _erf_inv(_uniform_of(bits, a, b))
    return np.clip(out, np.nextafter(lower, _F32(np.inf)), np.nextafter(upper, _F32(-np.inf)))


def _draw(key, shape, transform, out: np.ndarray) -> np.ndarray:
    """transform(words) for every flat index of `shape` into `out`, chunk by
    chunk on a pool of threads (numpy releases the interpreter's lock)."""
    n = math.prod(shape)
    flat = out.reshape(-1)

    def fill(start: int) -> None:
        stop = min(start + CHUNK, n)
        flat[start:stop] = transform(_bits(key, start, stop))

    with ThreadPoolExecutor(min(os.cpu_count() or 1, 8)) as pool:
        for f in [pool.submit(fill, s) for s in range(0, n, CHUNK)]:
            f.result()
    return out


def _fold_in_path(key, path: tuple) -> np.ndarray:
    """Flax's `_fold_in_static`: the first 4 bytes of the SHA-1 of the path."""
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode() if isinstance(x, str) else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def _lecun(key, shape, out: np.ndarray) -> np.ndarray:
    fan_in = shape[-2] * (math.prod(shape) / shape[-2] / shape[-1])
    stddev = np.sqrt(_F32(1.0 / fan_in)) / _F32(0.87962566103423978)
    return _draw(key, shape, lambda b: _truncated_normal_of(b, -2.0, 2.0) * stddev, out)


def _normal(key, shape, stddev: float) -> np.ndarray:
    s = _F32(stddev)
    return _draw(key, shape, lambda b: _normal_of(b) * s, np.empty(shape, _F32))


def draw_vit(dino: dict, seed: int = 0) -> dict:
    """The JAX seed-`seed` ViT as a state dict of float32 tensors. `dino`
    holds d_model, depth, num_heads, patch_size, pos_embed_size, mlp_ratio
    and init_values."""
    d, depth, p = dino["d_model"], dino["depth"], dino["patch_size"]
    hidden = int(d * dino["mlp_ratio"])
    kv = split(prng_key(seed))[0]
    patch = _lecun(_fold_in_path(kv, ("patch_embed", 1)), (p, p, 3, d), np.empty((p, p, 3, d), _F32))
    sd = {"patch_embed.proj.weight": np.transpose(patch, (3, 2, 0, 1)),
          "patch_embed.proj.bias": np.zeros(d, _F32),
          "cls_token": _normal(_fold_in_path(kv, (1,)), (1, 1, d), 1e-6),
          "pos_embed": _normal(_fold_in_path(kv, (2,)), (1, dino["pos_embed_size"] ** 2 + 1, d), 0.02),
          "norm.weight": np.ones(d, _F32), "norm.bias": np.zeros(d, _F32)}
    dense = {("attn", "qkv"): (d, 3 * d), ("attn", "proj"): (d, d),
             ("mlp", "fc1"): (d, hidden), ("mlp", "fc2"): (hidden, d)}
    layer_keys = split(kv, depth)
    for i in range(depth):
        t = f"blocks.{i}."
        for name in ("norm1", "norm2"):
            sd[t + name + ".weight"], sd[t + name + ".bias"] = np.ones(d, _F32), np.zeros(d, _F32)
        sd[t + "ls1.gamma"] = np.full(d, dino["init_values"], _F32)
        sd[t + "ls2.gamma"] = np.full(d, dino["init_values"], _F32)
        for (parent, name), shape in dense.items():
            # the scan's key a layer, Flax's path, the counter of the body's second trace
            key = _fold_in_path(layer_keys[i], ("blocks", "block", parent, name, 3))
            sd[f"{t}{parent}.{name}.weight"] = _lecun(key, shape, np.empty(shape, _F32)).T
            sd[f"{t}{parent}.{name}.bias"] = np.zeros(shape[1], _F32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def vit_state(dino: dict) -> dict:
    """The seed-0 ViT in bf16 on the host, drawn once and kept in `CACHE`."""
    tag = hashlib.sha256(Path(__file__).read_bytes() + json.dumps(dino, sort_keys=True).encode())
    path = CACHE / f"vit-{tag.hexdigest()[:16]}.pt"
    if not path.exists():
        CACHE.mkdir(parents=True, exist_ok=True)
        state = {k: v.to(torch.bfloat16) for k, v in draw_vit(dino).items()}
        tmp = path.with_suffix(".tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
    return torch.load(path, map_location="cpu", mmap=True)


# ----------------------------------------------------------------- the head
def _lin(w) -> np.ndarray:
    return np.asarray(w).T


def _conv(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _bn(sd: dict, p: dict, bs: dict, t: str) -> None:
    sd[t + "weight"], sd[t + "bias"] = p["scale"], p["bias"]
    sd[t + "running_mean"], sd[t + "running_var"] = bs["mean"], bs["var"]


def _conv_bn(sd: dict, p: dict, bs: dict, t_conv: str, t_bn: str) -> None:
    sd[t_conv + "weight"] = _conv(p["conv"]["kernel"])
    if "bias" in p["conv"]:
        sd[t_conv + "bias"] = p["conv"]["bias"]
    _bn(sd, p["bn"], bs["bn"], t_bn)


def _refine_block(sd: dict, p: dict, bs: dict, t: str) -> None:
    sd[t + "0.weight"], sd[t + "0.bias"] = _conv(p["dw"]["kernel"]), p["dw"]["bias"]
    _bn(sd, p["bn"], bs["bn"], t + "1.")
    sd[t + "3.weight"], sd[t + "3.bias"] = _conv(p["pw"]["kernel"]), p["pw"]["bias"]


def _index(tree, j: int):
    return {k: _index(v, j) for k, v in tree.items()} if isinstance(tree, dict) else np.asarray(tree)[j]


def head_from_flax(p: dict, bs: dict) -> dict:
    """The head's Flax params and batch_stats → the shared state dict."""
    sd: dict = {"dino_decoder.proj.weight": _lin(p["crossview"]["proj"]["kernel"])}
    cv = p["crossview"]
    for i in range(sum(k.startswith("cross") for k in cv)):
        c, t = cv[f"cross{i}"], f"dino_decoder.cross_attn_blocks.{i}."
        for n in ("norm1", "norm2"):
            sd[t + n + ".weight"], sd[t + n + ".bias"] = c[n]["scale"], c[n]["bias"]
        for proj in ("q_proj", "k_proj", "v_proj", "proj"):
            sd[t + f"attn.{proj}.weight"] = _lin(c["attn"][proj]["kernel"])
        sd[t + "attn.proj.bias"] = c["attn"]["proj"]["bias"]
        sd[t + "ls1.gamma"], sd[t + "ls2.gamma"] = c["ls1"]["gamma"], c["ls2"]["gamma"]
        for name in ("fc1", "fc2"):
            sd[t + f"mlp.{name}.weight"] = _lin(c[f"mlp_{name}"]["kernel"])
            sd[t + f"mlp.{name}.bias"] = c[f"mlp_{name}"]["bias"]
    for name in ("conv00", "conv01", "downsample1", "conv10", "conv11", "downsample2",
                 "conv20", "conv21", "downsample3", "conv30", "conv31"):
        _conv_bn(sd, p["encoder"][name], bs["encoder"][name], f"encoder.{name}.conv.", f"encoder.{name}.bn.")
    for name in ("out0", "inner1", "out1", "inner2", "out2", "inner3", "out3"):
        _conv_bn(sd, p["fpn_decoder"][name], bs["fpn_decoder"][name], f"decoder.{name}.0.", f"decoder.{name}.1.")
    _conv_bn(sd, p["merge_layer"], bs["merge_layer"], "merge_layer.0.", "merge_layer.1.")
    for scale in ("16", "8", "4", "2", "1"):
        rp, rb, t = p[f"refiners_{scale}"], bs[f"refiners_{scale}"], f"conv_refiner.{scale}."
        sd[t + "disp_emb.weight"], sd[t + "disp_emb.bias"] = _conv(rp["disp_emb"]["kernel"]), rp["disp_emb"]["bias"]
        sd[t + "out_conv.weight"], sd[t + "out_conv.bias"] = _conv(rp["out_conv"]["kernel"]), rp["out_conv"]["bias"]
        _refine_block(sd, rp["block1"], rb["block1"], t + "block1.")
        hp, hb = rp["hidden"]["block"], rb["hidden"]["block"]
        for j in range(np.asarray(hp["dw"]["bias"]).shape[0]):
            _refine_block(sd, _index(hp, j), _index(hb, j), f"{t}hidden_blocks.{j}.")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


KV_FLAG = "__protocol_kv_norm__"


def read_head(path: Path, sha256: str) -> tuple[dict, bool]:
    """(state dict, the file's k/v-standardization flag) of the head `.npz`
    at `path`, which has to hash to `sha256`."""
    data = Path(path).read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    if digest != sha256:
        raise ValueError(f"{path}: sha256 {digest} is not the configuration's {sha256}")
    tree: dict = {}
    with np.load(path) as raw:
        flag = bool(raw[KV_FLAG]) if KV_FLAG in raw.files else False
        for name in raw.files:
            if name == KV_FLAG:
                continue
            node = tree
            *parents, leaf = name.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = raw[name]
    return head_from_flax(tree["params"], tree["batch_stats"]), flag
