"""JAX's keys and draws, worked out again without JAX.

A key is a (2,) uint32 array, as `jax.random.PRNGKey(seed)` holds it.
Threefry-2x32 in JAX's partitionable layout: `split(key, n)[i]` and
`fold_in(key, i)` hash the counter (0, i); the words of a draw of n values
are hash(key, (0, j)) with their two halves xor-ed. `uniform_of` and
`randint_of` turn words into JAX's float32 uniforms and int32 `randint`
values. The host functions run in numpy, the draws on any torch device.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000


def threefry2x32_np(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under `key`."""
    k0, k1 = (np.full(1, int(k), np.uint32) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`: the 64-bit seed as (high, low) words."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")
    return np.array([seed >> 32, seed & MASK], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)` → (num, 2)."""
    y0, y1 = threefry2x32_np(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)` for a uint32 `data`."""
    y0, y1 = threefry2x32_np(key, np.zeros(1, np.uint32), np.full(1, data, np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def threefry2x32(k0: Tensor, k1: Tensor, x0: Tensor, x1: Tensor) -> tuple[Tensor, Tensor]:
    """The same hash on int64 tensors that hold uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def draw_words(keys, counts: list[int], device) -> Tensor:
    """The words of several draws, one after the other: draw j has key
    `keys[j]` and `counts[j]` values. int64 on `device`."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    device = torch.device(device)
    key_words = torch.from_numpy(keys.astype(np.int64)).to(device)
    which = torch.cat([torch.full((c,), j, dtype=torch.int64) for j, c in enumerate(counts)]).to(device)
    counter = torch.cat([torch.arange(c, dtype=torch.int64) for c in counts]).to(device)
    y0, y1 = threefry2x32(key_words[which, 0], key_words[which, 1], torch.zeros_like(counter), counter)
    return y0 ^ y1


def uniform_of(words: Tensor, minval: float, maxval: float) -> Tensor:
    """`jax.random.uniform`'s float32 values on [minval, maxval): the top 23
    bits as a float in [1, 2) minus 1, times (max - min) plus min in one
    rounding, then at least minval."""
    lo, hi = np.float32(minval), np.float32(maxval)
    unit = ((words >> 9) | _ONE_F32_BITS).to(torch.int32).view(torch.float32) - 1.0
    u = (unit.double() * float(hi - lo) + float(lo)).float()
    return u.clamp_min(float(lo))


def randint_of(hi_words: Tensor, lo_words: Tensor, minval: int, maxval: int) -> Tensor:
    """`jax.random.randint` from the words of `split(key)`'s two keys: each
    word modulo the span, joined by 2**32 mod span in uint32 arithmetic."""
    span = max(maxval - minval, 1)
    multiplier = (1 << 16) % span
    multiplier = multiplier * multiplier % (1 << 32) % span
    offset = (((hi_words % span) * multiplier) & MASK) + (lo_words % span)
    return (offset & MASK) % span + minval
