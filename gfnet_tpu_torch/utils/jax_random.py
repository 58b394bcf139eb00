"""JAX's random draws on the matcher's device.

`jax.random` draws with the Threefry-2x32 hash in the partitionable layout
(`utils/jax_init.py` says how). The sampler draws about 2·10⁵ Gumbel
uniforms a pair, so the draws that serving makes run here, on the tensors'
device, with the same arithmetic as the numpy plain version in
`utils/jax_init.py`: unsigned 32-bit words held in int64 tensors and masked
after each add and shift (torch's uint32 support is partial). Keys stay on
the host as (2,) uint32 numpy arrays, split there by `jax_init.split`:
a key is 8 bytes and a split hashes one counter.

`draw_words` hashes many segments (a key and a count each) in one pass of
about 170 elementwise launches, whatever their number, which is how the
matcher draws every pair's uniforms and RANSAC indices of a batch at once.
"""

from __future__ import annotations

import numpy as np
import torch

from gfnet_tpu_torch.utils import jax_init

Tensor = torch.Tensor

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000


def threefry2x32(k0: Tensor, k1: Tensor, x0: Tensor, x1: Tensor) -> tuple[Tensor, Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the key
    words (k0, k1): int64 tensors holding uint32 values, broadcastable."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1).bitwise_and_(MASK)
            x1 = ((x1 << r).bitwise_and_(MASK)).bitwise_or_(x1 >> (32 - r)).bitwise_xor_(x0)
        x0 = (x0 + ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x0, x1


def draw_words(keys, counts: list[int], device) -> Tensor:
    """The 32-bit random words of several draws at once: draw j has key
    `keys[j]` ((2,) uint32) and `counts[j]` values, the words of
    `jax.random.bits(keys[j], (counts[j],))`. Returns them one draw after
    the other in one int64 tensor on `device`."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    device = torch.device(device)
    key_words = torch.from_numpy(keys.astype(np.int64)).to(device)
    total = int(sum(counts))
    sizes = torch.tensor(counts, device=device)
    which = torch.repeat_interleave(torch.arange(len(counts), device=device), sizes, output_size=total)
    starts = torch.cumsum(sizes, 0) - sizes
    counter = torch.arange(total, device=device) - starts[which]
    y0, y1 = threefry2x32(key_words[which, 0], key_words[which, 1], torch.zeros_like(counter), counter)
    return y0 ^ y1


def unit_float(words: Tensor) -> Tensor:
    """Random words → float32 in [0, 1) by their top 23 bits, as JAX's
    uniform builds them."""
    return ((words >> 9) | _ONE_F32_BITS).to(torch.int32).view(torch.float32) - 1.0


def uniform_of(words: Tensor, minval: float, maxval: float) -> Tensor:
    """`jax.random.uniform`'s float32 values on [minval, maxval) from its
    words: floats · (max - min) + min as one fused multiply-add (a float64
    product of two float32 values is exact), then at least minval."""
    lo, hi = np.float32(minval), np.float32(maxval)
    u = (unit_float(words).double() * float(hi - lo) + float(lo)).float()
    return u.clamp_min(float(lo))


def randint_of(hi_words: Tensor, lo_words: Tensor, minval: int, maxval: int) -> Tensor:
    """`jax.random.randint` in int64 from the words of `split(key)`'s two
    keys (`jax_init.randint` says how)."""
    span = max(maxval - minval, 1)
    multiplier = (1 << 16) % span
    multiplier = multiplier * multiplier % (1 << 32) % span
    offset = ((hi_words % span) * multiplier).bitwise_and_(MASK).add_(lo_words % span).bitwise_and_(MASK)
    return offset % span + minval


def random_bits(key, shape, device) -> Tensor:
    """`jax.random.bits(key, shape, uint32)` as int64 on `device`."""
    return draw_words([key], [int(np.prod(shape))], device).reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0, device="cpu") -> Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)` on `device`."""
    return uniform_of(random_bits(key, shape, device), minval, maxval)


def randint(key, shape, minval: int, maxval: int, device="cpu") -> Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` as int64 on `device`."""
    n = int(np.prod(shape))
    hi, lo = draw_words(jax_init.split(key), [n, n], device).view(2, n)
    return randint_of(hi, lo, minval, maxval).reshape(shape)
