"""The plain PyTorch versions of the CUDA kernels (K1, K2 and K3, the local
correlation's gradient in the query) against the JAX package's Pallas
kernels, run in interpret mode on the CPU as tests/test_oneshot_attention.py
and tests/test_pallas.py run them; K4's plain version (the KDE, whose JAX
counterpart is left to XLA and tested in tests/test_torch_ops.py) on the CPU.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda_kernels.py.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfnet_tpu.ops.attention import scaled_dot_product_attention as jax_sdpa
from gfnet_tpu.ops.pallas.local_corr import local_correlation_pallas
from gfnet_tpu.ops.pallas.oneshot_attention import oneshot_attention
from gfnet_tpu_torch.ops import kernels
from gfnet_tpu_torch.ops.attention import (attention_tf32_plain, column_group_attention_plain,
                                           entropy_invariant_scale, fused_attention, kv_split_attention_plain,
                                           scaled_dot_product_attention, streamed_attention_plain, tf32_round)
from gfnet_tpu_torch.eval.flows import FLOW_KINDS, homography_flow, kernel_flow
from gfnet_tpu_torch.ops.kde import kde, kde_plain
from gfnet_tpu_torch.ops.local_correlation import (_local_correlation_patch, corr_tile_boxes,
                                                   local_corr_dq_plain, local_corr_dq_tiled_plain,
                                                   local_corr_tiled_plain, local_correlation, pad_channels)
from torch_cpu import one_thread  # noqa: F401


def T(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("b,n,h,d,scale", [
    (2, 130, 3, 64, None),          # ragged kv: the Pallas kernel pads 130 → 256 and masks
    (1, 200, 2, 8, entropy_invariant_scale(8, 200, 64)),  # cross-view head dim, custom scale
    (2, 96, 2, 16, 0.3),
])
def test_sdpa_matches_oneshot_pallas(b, n, h, d, scale):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, (b, n, h, d)).astype(np.float32) for _ in range(3))
    want = oneshot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, interpret=True)
    got = scaled_dot_product_attention(T(q), T(k), T(v), scale)
    # float32 both sides; the kernel divides by the row sum after PV
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_sdpa_matches_oneshot_pallas_kv_longer_than_q():
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (1, 40, 2, 8)).astype(np.float32)
    k, v = (rng.normal(0, 1, (1, 150, 2, 8)).astype(np.float32) for _ in range(2))
    want = oneshot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.5, interpret=True)
    np.testing.assert_allclose(scaled_dot_product_attention(T(q), T(k), T(v), 0.5).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,nq,nk,h,d,scale,tile", [
    (2, 65, 65, 3, 64, None, 64),           # one key in the last tile, as N = 1025 = 16·64 + 1
    (2, 130, 130, 2, 64, None, 64),
    (1, 65, 65, 2, 8, entropy_invariant_scale(8, 65, 64), 64),
    (2, 130, 130, 2, 8, entropy_invariant_scale(8, 130, 64), 64),
    (1, 40, 150, 2, 8, 0.5, 64),            # kv longer than q
    (1, 65, 130, 2, 64, None, 64),
    (1, 130, 130, 2, 16, 0.3, 32),          # more tiles, more rescales
])
def test_streamed_attention_matches_oneshot_pallas(b, nq, nk, h, d, scale, tile):
    """The schedule of the CUDA kernels (kv tiles, running max and sum, exp2
    with the scale folded, division after PV) against the Pallas kernel."""
    rng = np.random.default_rng(11)
    q = rng.normal(0, 1, (b, nq, h, d)).astype(np.float32)
    k, v = (rng.normal(0, 1, (b, nk, h, d)).astype(np.float32) for _ in range(2))
    want = oneshot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, interpret=True)
    got = streamed_attention_plain(T(q), T(k), T(v), scale, tile)
    # float32 both sides: summation order and exp2 against exp; a sound run read at most 3.6e-7
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nq,nk,d,scale", [(130, 130, 64, None), (65, 130, 8, entropy_invariant_scale(8, 65, 64))])
def test_streamed_attention_matches_oneshot_pallas_bf16(nq, nk, d, scale):
    rng = np.random.default_rng(12)
    q = rng.normal(0, 1, (2, nq, 2, d)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, nk, 2, d)).astype(np.float32) for _ in range(2))
    want = oneshot_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale=scale, interpret=True)
    got = streamed_attention_plain(*(T(a, torch.bfloat16) for a in (q, k, v)), scale)
    # bf16 operands, probabilities and output on both sides: one rounding of the
    # output (a sound run read 2.0e-3)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("d", [320, 512])
def test_streamed_attention_box_by_box_is_the_plain_function(d):
    """Above head dim 256 the bf16 kernel sums the logits one 64-channel box
    at a time (`box=64`); that schedule, on ragged q (77) and kv (130) over 2
    heads, against the float32 plain version, float32 both sides (sound
    runs read 2.0e-6 at D = 320 and 4.8e-7 at 512)."""
    rng = np.random.default_rng(d)
    q = T(rng.normal(0, 1, (1, 77, 2, d)))
    k, v = (T(rng.normal(0, 1, (1, 130, 2, d))) for _ in range(2))
    torch.testing.assert_close(streamed_attention_plain(q, k, v, d**-0.5, box=64),
                               scaled_dot_product_attention(q, k, v, d**-0.5), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_head_dim_matches_oneshot_pallas(dtype):
    """D = 384, which the bf16 wide kernel takes at its own width: the port's
    plain path (`fused_attention` on CPU tensors) and the wide kernel's
    schedule (`streamed_attention_plain(box=64)`) against JAX's Pallas K1 in
    interpret mode, ragged q (77) and kv (130) over 2 heads. float32: 2e-5
    (summation order; a sound run read 1.1e-6); bf16 operands, probabilities
    and output on both sides: 1e-2, one rounding of the bf16 output, as the
    bf16 test above (a sound run read 3.9e-3)."""
    rng = np.random.default_rng(384)
    q = rng.normal(0, 1, (1, 77, 2, 384)).astype(np.float32)
    k, v = (rng.normal(0, 1, (1, 130, 2, 384)).astype(np.float32) for _ in range(2))
    scale = 384**-0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(oneshot_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), scale=scale, interpret=True),
                      np.float32)
    qt, kt, vt = (T(a, tdt) for a in (q, k, v))
    tol = 2e-5 if dtype == "float32" else 1e-2
    streamed = streamed_attention_plain(qt, kt, vt, scale, box=64).float().numpy()
    np.testing.assert_allclose(streamed, want, rtol=tol, atol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(fused_attention(qt, kt, vt, scale).numpy(), want, rtol=tol, atol=tol)


def test_streamed_attention_is_the_plain_function():
    rng = np.random.default_rng(13)
    q, k, v = (T(rng.normal(0, 1, (2, 70, 2, 8))) for _ in range(3))
    torch.testing.assert_close(streamed_attention_plain(q, k, v, 0.4, tile=16),
                               scaled_dot_product_attention(q, k, v, 0.4), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [12, 32, 128, 20, 100, 200, 300])
def test_pad_head_dim_equals_the_unpadded_plain_version(d):
    """K1's head-dim padding (`kernels.pad_head_dim`, which the CUDA wrapper
    runs before a launch) on the plain version: D = 12, 20, 100 and 200 are
    zero-padded to 16, 32, 128 and 256, D = 32 and 128 pass through, D = 300
    pads q and k to 320 and v to 512. At D = 12 also against the Pallas
    kernel, which takes any head dim. float32, the padded sums only add
    zeros: a sound run read at most 1.2e-7."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.normal(0, 1, (1, 40, 2, d)).astype(np.float32) for _ in range(3))
    scale = d**-0.5
    got = kernels.pad_head_dim(scaled_dot_product_attention, T(q), T(k), T(v), scale)
    assert got.shape == (1, 40, 2, d)
    assert got.is_contiguous() or d in kernels.ATTENTION_HEAD_DIMS
    if d == 300:  # the column groups' v: two groups of 256
        torch.testing.assert_close(kernels.pad_head_dim(column_group_attention_plain, T(q), T(k), T(v), scale),
                                   got, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, scaled_dot_product_attention(T(q), T(k), T(v), scale), rtol=1e-6, atol=1e-6)
    if d == 12:
        want = oneshot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_attention_head_dim_pads_up_and_groups_columns_above_256():
    """Every head dim has a width: the next instantiated one up to 256, and
    above it q/k at a multiple of 64, and v at a multiple of 64 in bf16 (the
    wide kernel's boxes) or in whole groups of 256 columns in float32. The
    float32 column groups' decomposition (logits over the whole head dim, the
    same for each group, then 256 output columns at a time) through the
    padding, at D = 256 and 320, against the Pallas kernel in interpret mode,
    float32 (a sound run read at most 8.3e-7)."""
    assert [kernels.attention_head_dim(d) for d in (1, 8, 12, 16, 24, 33, 64, 96, 128, 129, 256, 257, 320, 600)] == \
        [8, 8, 16, 16, 32, 64, 64, 128, 128, 256, 256, 320, 320, 640]
    assert [kernels.attention_value_dim(d, bf16=False) for d in (12, 129, 256, 257, 320, 512, 600)] == \
        [16, 256, 256, 512, 512, 512, 768]
    assert [kernels.attention_value_dim(d, bf16=True) for d in (12, 129, 256, 257, 300, 320, 384, 512, 600)] == \
        [16, 256, 256, 320, 320, 320, 384, 512, 640]
    # what the wrapper hands the kernels at D = 300: q and k at 320 in both
    # types, v at 320 in bf16 and 512 in float32
    widths = []
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros((1, 3, 1, 300), dtype=dtype)
        kernels.pad_head_dim(lambda q, k, v, scale: widths.append((q.shape[-1], k.shape[-1], v.shape[-1])) or v,
                             x, x, x, 1.0)
    assert widths == [(320, 320, 320), (320, 320, 512)]
    rng = np.random.default_rng(320)
    for d in (256, 320):
        q, k, v = (rng.normal(0, 1, (1, 24, 2, d)).astype(np.float32) for _ in range(3))
        got = kernels.pad_head_dim(column_group_attention_plain, T(q), T(k), T(v), d**-0.5)
        assert got.shape == (1, 24, 2, d)
        want = oneshot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=d**-0.5, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [8, 64])
def test_three_tf32_passes_give_float32(d):
    """The float32 kernel's numbers on the CPU: each product of Q·Kᵀ and P·V
    as hi·hi + hi·lo + lo·hi of TF32 halves (rounded by bit operations as
    `cvt.rna.tf32.f32` rounds) equals the float32 plain version within 1e-5,
    where one TF32 pass reads at least ten times more (sound runs read 6.6e-7
    and 8.9e-7, one pass 7.1e-4 and 8.9e-4)."""
    rng = np.random.default_rng(d)
    q, k, v = (T(rng.normal(0, 1, (2, 96, 2, d))) for _ in range(3))
    want = scaled_dot_product_attention(q, k, v, d**-0.5)
    three = (attention_tf32_plain(q, k, v, d**-0.5, passes=3) - want).abs().max().item()
    one = (attention_tf32_plain(q, k, v, d**-0.5, passes=1) - want).abs().max().item()
    assert three <= 1e-5 and one >= 10 * three, (three, one)
    assert torch.equal(tf32_round(T([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11)])),
                       T([1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10)]))  # ties away from zero


@pytest.mark.parametrize("nk,kv_split", [(130, 64), (300, 128)])
def test_kv_split_merge_matches_oneshot_pallas(nk, kv_split):
    """K1's kv split and merge (`kv_split_attention_plain`: each range's
    unnormalised output, max and sum, combined by their log-sum-exp) against
    the Pallas kernel, float32, and the split plan keeps whole tiles, at
    least two a split, within the blocks the SMs hold (a sound run read
    2.2e-7)."""
    rng = np.random.default_rng(nk)
    q = rng.normal(0, 1, (1, 40, 2, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (1, nk, 2, 16)).astype(np.float32) for _ in range(2))
    want = oneshot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3, interpret=True)
    got = kv_split_attention_plain(T(q), T(k), T(v), 0.3, kv_split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert kernels.attention_splits(True, 2, 1024, 1024, 1, 128, 128, 132) == (8, 128)
    assert kernels.attention_splits(False, 2, 1024, 1024, 1, 320, 512, 132) == (4, 256)  # float32: 2 an SM
    assert kernels.attention_splits(True, 16, 1024, 1024, 1, 128, 128, 132) == (1, 1024)  # 128 blocks
    assert kernels.attention_splits(True, 2, 1024, 1024, 8, 8, 8, 132) == (1, 1024)  # 128 blocks
    assert kernels.attention_splits(True, 2, 1024, 1024, 1, 320, 320, 132) == (4, 256)  # one slab: 32 blocks
    assert kernels.attention_splits(True, 2, 1024, 1024, 1, 512, 512, 132) == (4, 256)  # one slab of 512
    assert kernels.attention_splits(True, 2, 1024, 1024, 1, 640, 640, 132) == (2, 512)  # two slabs: 64 blocks
    assert kernels.attention_splits(True, 16, 1024, 1024, 1, 320, 320, 132) == (1, 1024)  # 256 blocks
    for args in ((False, 1, 200, 2100, 1, 8, 8, 132), (False, 2, 1024, 1024, 2, 32, 32, 132)):
        splits, per = kernels.attention_splits(*args)
        assert per % 64 == 0 and per >= 128 and (splits - 1) * per < args[3] <= splits * per


def test_fused_attention_takes_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    q, k, v = (T(rng.normal(0, 1, (1, 33, 2, 8))) for _ in range(3))
    before = kernels.launch_counts()
    torch.testing.assert_close(fused_attention(q, k, v, 0.4), scaled_dot_product_attention(q, k, v, 0.4))
    assert kernels.launch_counts() == before


def test_sdpa_grad_matches_jax():
    """The plain attention's gradient, which the CUDA `fused_attention`
    recomputes in backward, against `jax.grad` of the einsum SDPA that backs
    the JAX package's `_oneshot_sdpa_grad`; cross-view head dim, entropy scale."""
    rng = np.random.default_rng(6)
    b, n, h, d = 2, 90, 2, 8
    scale = entropy_invariant_scale(d, n, 64)
    q, k, v, g = (rng.normal(0, 1, (b, n, h, d)).astype(np.float32) for _ in range(4))
    want = jax.grad(lambda *a: jnp.sum(jax_sdpa(*a, scale) * jnp.asarray(g)), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (T(a).requires_grad_() for a in (q, k, v))
    got = torch.autograd.grad(fused_attention(tq, tk, tv, scale), (tq, tk, tv), T(g))
    # float32 both sides, sums over 90 keys; a sound run read at most 7.2e-7
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------- local correlation
@pytest.mark.parametrize("radius,g,h,c", [(1, 4, 6, 8), (2, 8, 8, 8), (3, 8, 14, 16)])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_local_corr_patch_matches_pallas(radius, g, h, c, storage):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, g, g, c)).astype(np.float32)
    t = rng.standard_normal((2, h, h, c)).astype(np.float32)
    fl = rng.uniform(-1.3, 1.3, (2, g, g, 2)).astype(np.float32)
    jdt = jnp.bfloat16 if storage == "bfloat16" else jnp.float32
    want = local_correlation_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(fl), radius, True, jdt)
    tdt = getattr(torch, storage)
    got = _local_correlation_patch(T(q, tdt), T(t, tdt), T(fl), radius)
    # both sides see the same storage-rounded values and accumulate in float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("value", [5.0, -7.0, math.nan, math.inf])
def test_local_corr_out_of_range_and_nonfinite_flow_is_zero(value):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 4, 4, 8)).astype(np.float32)
    t = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    fl = np.full((1, 4, 4, 2), value, np.float32)
    got = _local_correlation_patch(T(q), T(t), T(fl), 2)
    want = local_correlation_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(fl), 2, True)
    assert torch.count_nonzero(got) == 0
    np.testing.assert_array_equal(np.asarray(want), 0.0)


CORR_GRAD_SHAPES = [(1, 4, 6, 8), (2, 8, 8, 8), (3, 8, 14, 16)]


def _corr_grad_inputs(radius, g, h, c, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, g, g, c)).astype(np.float32)
    t = rng.standard_normal((2, h, h, c)).astype(np.float32)
    fl = rng.uniform(-1.3, 1.3, (2, g, g, 2)).astype(np.float32)
    grad = rng.standard_normal((2, g, g, (2 * radius + 1) ** 2)).astype(np.float32)
    return q, t, fl, grad


@pytest.mark.parametrize("radius,g,h,c", CORR_GRAD_SHAPES)
def test_local_corr_dq_plain_matches_pallas_grad(radius, g, h, c):
    """K3's plain version against `jax.grad` through the Pallas kernel's
    custom VJP (`_bwd_kernel`, interpret mode), as tests/test_pallas.py runs it."""
    q, t, fl, grad = _corr_grad_inputs(radius, g, h, c, 7)
    want = jax.grad(lambda qq: jnp.sum(local_correlation_pallas(
        qq, jnp.asarray(t), jnp.asarray(fl), radius, True) * jnp.asarray(grad)))(jnp.asarray(q))
    got = local_corr_dq_plain(T(grad), T(t), T(fl), radius)
    # float32 both sides, sums of at most 64·16 terms; a sound run read at most 9.5e-7
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("radius,g,h,c", CORR_GRAD_SHAPES)
def test_local_corr_dq_plain_matches_autograd(radius, g, h, c):
    q, t, fl, grad = _corr_grad_inputs(radius, g, h, c, 8)
    tq = T(q).requires_grad_()
    (want,) = torch.autograd.grad(_local_correlation_patch(tq, T(t), T(fl), radius), tq, T(grad))
    # the same float32 products in another order
    torch.testing.assert_close(local_corr_dq_plain(T(grad), T(t), T(fl), radius), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("value", [5.0, -7.0, math.nan, math.inf])
def test_local_corr_dq_out_of_range_and_nonfinite_flow_is_zero(value):
    rng = np.random.default_rng(9)
    grad = rng.standard_normal((1, 4, 4, 25)).astype(np.float32)
    t = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    fl = np.full((1, 4, 4, 2), value, np.float32)
    assert torch.count_nonzero(local_corr_dq_plain(T(grad), T(t), T(fl), 2)) == 0
    want = jax.grad(lambda qq: jnp.sum(local_correlation_pallas(
        qq, jnp.asarray(t), jnp.asarray(fl), 2, True) * jnp.asarray(grad)))(jnp.zeros((1, 4, 4, 8)))
    np.testing.assert_array_equal(np.asarray(want), 0.0)


@pytest.mark.parametrize("c,storage", [(12, "bfloat16"), (6, "float32")])
def test_local_correlation_padded_channels_match_pallas(c, storage):
    """K2/K3 at a pixel that is not a whole number of 16-byte vectors: the
    padding path (`pad_channels` on query and target, the caller's 1/√C, dq
    sliced back to C) through the plain versions against the Pallas kernel
    and its gradient in interpret mode, at the same storage-rounded values
    (a sound run read at most 7.7e-7)."""
    radius, g, h = 2, 6, 10
    q, t, fl, grad = _corr_grad_inputs(radius, g, h, c, 13)
    tdt, jdt = getattr(torch, storage), getattr(jnp, storage)
    qs, ts = (T(a, tdt).float().numpy() for a in (q, t))  # the storage's values, as float32
    want = local_correlation_pallas(jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(fl), radius, True, jdt)
    want_dq = jax.grad(lambda qq: jnp.sum(local_correlation_pallas(
        qq, jnp.asarray(ts), jnp.asarray(fl), radius, True, jdt) * jnp.asarray(grad)))(jnp.asarray(qs))
    pq, pt = pad_channels(T(q, tdt)), pad_channels(T(t, tdt))
    assert pq.shape[-1] * pq.element_size() % 16 == 0 and pq.shape[-1] > c
    got = _local_correlation_patch(pq, pt, T(fl), radius, scale=1.0 / math.sqrt(c))
    dq = local_corr_dq_plain(T(grad), pt, T(fl), radius, scale=1.0 / math.sqrt(c))[..., :c]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), rtol=1e-5, atol=1e-5)


def test_local_correlation_gradient_reaches_the_query_only():
    rng = np.random.default_rng(10)
    q, t, fl = (T(a).requires_grad_() for a in (rng.standard_normal((1, 5, 5, 4)),
                                                rng.standard_normal((1, 9, 9, 4)),
                                                rng.uniform(-1, 1, (1, 5, 5, 2))))
    out = local_correlation(q, t, fl, 2)
    grad = T(rng.standard_normal(tuple(out.shape)))
    out.backward(grad)
    assert t.grad is None and fl.grad is None
    torch.testing.assert_close(q.grad, local_corr_dq_plain(grad, t.detach(), fl.detach(), 2),
                               rtol=1e-5, atol=1e-5)


def test_local_correlation_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    q, t = T(rng.standard_normal((1, 5, 5, 4))), T(rng.standard_normal((1, 9, 9, 4)))
    fl = T(rng.uniform(-1, 1, (1, 5, 5, 2)))
    before = kernels.launch_counts()
    torch.testing.assert_close(local_correlation(q, t, fl, 2), _local_correlation_patch(q, t, fl, 2))
    assert kernels.launch_counts() == before


# ------------------------------------------- local correlation, tiled schedule
def _tiled_case(case):
    """(radius, tile, box, numpy inputs q, t, flow, grad) for one case of
    the kernels' tiled schedule at a small size: r2, C8, 14² target, 8² grid
    (1.75 target pixels a cell, as at the main path's r6/r4/r2 shapes), 4×4
    tiles and the 16×16 box `kernels.corr_box` gives them."""
    rng = np.random.default_rng(21)
    radius, g, h, c, tile = 2, 8, 14, 8, (4, 4)
    box = kernels.corr_box(radius, tile, (h / g, h / g))
    if case == "ragged":  # 10² grid: the 4×4 tiles leave 2-cell strips
        g = 10
    flow = homography_flow(rng, 2, g, (h, h)).numpy()
    if case == "random":
        flow = rng.uniform(-1.3, 1.3, (2, g, g, 2)).astype(np.float32)
    if case == "mixed":  # one tile of NaN, inf, far-out and edge-straddling cells among sound ones
        flow[0, 0, 0] = np.nan
        flow[0, 0, 1, 0] = np.inf
        flow[0, 1, 0] = (5.0, -6.0)
        flow[0, 1, 1] = (-1.1, -1.05)  # the window straddles the map's corner
        flow[0, 2, 2, 1] = -np.inf
    if case == "small_box":  # a box smaller than one window: everything goes per cell
        box = (2 * radius + 1, 2 * radius + 1)
    q = rng.standard_normal((2, g, g, c)).astype(np.float32)
    t = rng.standard_normal((2, h, h, c)).astype(np.float32)
    grad = rng.standard_normal((2, g, g, (2 * radius + 1) ** 2)).astype(np.float32)
    return radius, tile, box, q, t, flow, grad


TILED_CASES = ["homography", "random", "mixed", "ragged", "small_box"]


def _check_staging(case, flow, h, radius, tile, box):
    _, staged = corr_tile_boxes(T(flow), h, h, radius, tile, box)
    share = staged.float().mean().item()
    want = {"homography": share > 0.8, "random": share == 0.0, "mixed": bool(staged[0, 0, 0]) and share > 0.8,
            "ragged": share > 0.8 and staged.shape[1:] == (3, 3), "small_box": share == 0.0}[case]
    assert want, (case, share)


@pytest.mark.parametrize("case", TILED_CASES)
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_local_corr_tiled_plain_matches_pallas(case, storage):
    """K2's schedule (tile → union box → patches from the staged box or per
    cell) against the Pallas kernel in interpret mode."""
    radius, tile, box, q, t, fl, _ = _tiled_case(case)
    _check_staging(case, fl, t.shape[1], radius, tile, box)
    jdt = jnp.bfloat16 if storage == "bfloat16" else jnp.float32
    want = local_correlation_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(fl), radius, True, jdt)
    tdt = getattr(torch, storage)
    got = local_corr_tiled_plain(T(q, tdt), T(t, tdt), T(fl), radius, tile, box)
    # both sides see the same storage-rounded values and accumulate in float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if case == "mixed":
        assert torch.count_nonzero(got[0, 0, :2]) == 0 and torch.count_nonzero(got[0, 1, 0]) == 0
        assert torch.count_nonzero(got[0, 1, 1]) > 0


@pytest.mark.parametrize("case", TILED_CASES)
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_local_corr_dq_tiled_plain_matches_pallas_grad(case, storage):
    """K3's schedule against `jax.grad` through the Pallas kernel's custom
    VJP. K3 takes the target in its storage type and the gradient in float32;
    the Pallas kernel's bf16 mode would round the gradient too, so the bf16
    case hands it the bf16-rounded target in float32."""
    radius, tile, box, q, t, fl, grad = _tiled_case(case)
    _check_staging(case, fl, t.shape[1], radius, tile, box)
    tt = T(t, getattr(torch, storage))
    want = jax.grad(lambda qq: jnp.sum(local_correlation_pallas(
        qq, jnp.asarray(tt.float().numpy()), jnp.asarray(fl), radius, True) * jnp.asarray(grad)))(jnp.asarray(q))
    got = local_corr_dq_tiled_plain(T(grad), tt, T(fl), radius, tile, box)
    # float32 sums of at most 36·8 terms on the same storage-rounded target
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if case == "mixed":
        assert torch.count_nonzero(got[0, 0, :2]) == 0 and torch.count_nonzero(got[0, 1, 0]) == 0


@pytest.mark.parametrize("bad", [math.nan, math.inf, 5.0, -40.0])
def test_corr_tile_boxes_outside_cells_widen_no_box(bad):
    """A cell whose window misses the map, or whose flow is not finite, does
    not move its tile's corner or stop the tile from staging, and a tile of
    such cells stages nothing."""
    rng = np.random.default_rng(22)
    radius, g, h, tile = 3, 8, 14, (4, 4)
    box = kernels.corr_box(radius, tile, (h / g, h / g))
    flow = homography_flow(rng, 1, g, (h, h), perturb=0.05)
    corner, staged = corr_tile_boxes(flow, h, h, radius, tile, box)
    assert bool(staged.all())
    broken = flow.clone()
    broken[0, 1, 2] = bad       # one cell of tile (0, 0)
    broken[0, 4:, 4:] = bad     # all of tile (1, 1)
    corner2, staged2 = corr_tile_boxes(broken, h, h, radius, tile, box)
    assert bool(staged2[0, 0, 0]) and not bool(staged2[0, 1, 1])
    assert bool(staged2[0, 0, 1]) and bool(staged2[0, 1, 0])
    assert torch.equal(corner2[0, 0, 1], corner[0, 0, 1]) and torch.equal(corner2[0, 1, 0], corner[0, 1, 0])
    # tile (0, 0): its corner is the least base of its other cells, which is
    # at least the sound corner (the broken cell can only shrink the union)
    assert bool((corner2[0, 0, 0] >= corner[0, 0, 0]).all())
    inside_only = flow.clone()[0, :4, :4].reshape(-1, 2)
    keep = torch.ones(16, dtype=torch.bool)
    keep[1 * 4 + 2] = False
    px = ((inside_only[keep, 0] + 1) * h - 1) * 0.5
    py = ((inside_only[keep, 1] + 1) * h - 1) * 0.5
    want = torch.stack([torch.floor(px).min(), torch.floor(py).min()]).to(torch.int64) - radius
    assert torch.equal(corner2[0, 0, 0], want)


# (radius, C, target side, grid side, batch, element bytes) of every K2/K3
# launch on the main path: inference in bf16 (one pair), training in float32
CORR_LAUNCH_SHAPES = [(7, 64, 32, 32, 2, 2), (6, 64, 56, 32, 2, 2), (6, 64, 70, 40, 2, 2),
                      (4, 32, 112, 64, 2, 2), (4, 32, 140, 80, 2, 2), (2, 16, 224, 128, 2, 2),
                      (2, 16, 280, 160, 2, 2), (7, 64, 32, 32, 8, 4), (6, 64, 56, 32, 8, 4),
                      (4, 32, 112, 64, 8, 4), (2, 16, 224, 128, 8, 4)]


def test_corr_schedule_fits_and_refuses():
    """At every main-path shape the schedule fits three blocks an SM and
    gives at least two blocks an SM, for K2 and K3; what TMA cannot stage
    raises."""
    for r, c, t, g, b, elem in CORR_LAUNCH_SHAPES:
        for query_rows in (True, False):
            s = kernels.corr_schedule(r, c, elem, t, t, g, g, b, query_rows)
            assert s.smem[3] <= kernels.CORR_SMEM_BUDGET
            assert b * -(-g // s.tile[0]) * -(-g // s.tile[1]) >= kernels.CORR_MIN_BLOCKS
            assert c % s.chunk == 0 and s.chunk * elem in (16, 32, 64, 128) and max(s.box) <= 256
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.corr_schedule(1, 4, 2, 8, 8, 4, 4, 1, True)
    with pytest.raises(ValueError, match="radius"):
        kernels.corr_schedule(200, 8, 2, 500, 500, 4, 4, 1, True)


@pytest.mark.parametrize("r,c,t,g,b,elem", CORR_LAUNCH_SHAPES)
def test_corr_layout_holds_each_area(r, c, t, g, b, elem):
    """The shared-memory layout the kernels are handed: the box of one chunk
    at 0, then the cells' (2r+2)² floats, the query rows (K2 only) and the
    pixel table, each area 128-byte aligned and large enough, with 128 bytes
    of slack; K3's leaves the query rows out."""
    win2 = (2 * r + 2) ** 2
    for query_rows in (True, False):
        s = kernels.corr_schedule(r, c, elem, t, t, g, g, b, query_rows)
        cells_at, query_at, table_at, total = s.smem
        cells = s.tile[0] * s.tile[1]
        assert cells_at % 128 == query_at % 128 == table_at % 128 == 0
        assert cells_at >= s.box[0] * s.box[1] * s.chunk * elem
        assert query_at - cells_at >= cells * win2 * 4
        assert table_at - query_at == (-(-cells * c * elem // 128) * 128 if query_rows else 0)
        assert total - 128 - table_at >= win2 * 4
        same_tiling = kernels.corr_layout(r, c, elem, s.tile, s.box, s.chunk, not query_rows)
        assert (same_tiling.smem[3] < total) == query_rows


def test_corr_schedule_is_cached():
    """A launch looks its schedule up: the same shapes give the same object."""
    args = (6, 64, 2, 70, 70, 40, 40, 2, True)
    assert kernels.corr_schedule(*args) is kernels.corr_schedule(*args)


@pytest.mark.parametrize("kind", FLOW_KINDS)
def test_kernel_flows_stage_as_named(kind):
    """The flows the kernels are checked and timed on take the branches their
    names promise at the slowest inference shape (r6, 40² cells, 70² target)."""
    flow = kernel_flow(kind, 2, 40, 70, 20)
    assert flow.shape == (2, 40, 40, 2) and flow.dtype == torch.float32
    s = kernels.corr_schedule(6, 64, 2, 70, 70, 40, 40, 2, True)
    share = corr_tile_boxes(flow, 70, 70, 6, s.tile, s.box)[1].float().mean().item()
    assert {"homography": share > 0.85, "random": share == 0.0, "staged_only": share == 1.0,
            "mixed": 0.0 < share < 1.0}[kind], share
    torch.testing.assert_close(flow, kernel_flow(kind, 2, 40, 70, 20), rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("fn,args", [
    (kernels.oneshot_attention, lambda: (torch.zeros(1, 4, 1, 8),) * 3 + (0.5,)),
    (kernels.local_corr, lambda: (torch.zeros(1, 2, 2, 4), torch.zeros(1, 3, 3, 4), torch.zeros(1, 2, 2, 2), 1)),
    (kernels.local_corr_bwd, lambda: (torch.zeros(1, 2, 2, 9), torch.zeros(1, 3, 3, 4), torch.zeros(1, 2, 2, 2), 1)),
    (kernels.kde, lambda: (torch.zeros(1, 5, 4), torch.zeros(1, 5), -50.0)),
])
def test_kernel_wrappers_refuse_cpu_tensors(fn, args):
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args())


# ------------------------------------------------------------------ K4, KDE
@pytest.mark.parametrize("form", ["batched", "unbatched", "two_leading_dims", "d3", "d2", "bf16", "float64",
                                  "strided"])
def test_kde_takes_plain_version_on_cpu(monkeypatch, form):
    def refuse(*args):
        raise AssertionError("K4 launched for a CPU tensor")

    monkeypatch.setattr(kernels, "kde", refuse)
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (2, 3, 60, 4)).astype(np.float32))
    x = {"batched": x[0], "unbatched": x[0, 0], "two_leading_dims": x, "d3": x[0, ..., :3], "d2": x[0, ..., :2],
         "bf16": x[0].to(torch.bfloat16), "float64": x[0].double(), "strided": x[0, :, ::2]}[form]
    before = kernels.launch_counts()
    got = kde(x)
    assert got.dtype == torch.float32 and got.shape == x.shape[:-1]
    assert torch.equal(got, kde_plain(x)) and kernels.launch_counts() == before


@pytest.mark.parametrize("b,n,block", [(1, 1, 4096), (3, 37, 16), (2, 301, 64), (4, 50, 3)])
def test_kde_plain_rows_in_blocks_match_pairwise_distances(b, n, block):
    """Every row once, whatever the block (N not a multiple of it, a block
    smaller than the batch), against Σ_j exp(−|x_i − x_j|² / (2·0.1²)) in
    float64: the float32 d² = |x_i|² + |x_j|² − 2·x_i·x_j rounds within
    ~1e-6, 50 times that in a term's exponent."""
    x = torch.from_numpy(np.random.default_rng(b * 1000 + n).uniform(-1, 1, (b, n, 4)).astype(np.float32))
    xd = x.double()
    want = torch.exp(-((xd[:, :, None] - xd[:, None]) ** 2).sum(-1) / (2 * 0.1 ** 2)).sum(-1)
    got = kde_plain(x, std=0.1, block=block)
    assert got.shape == (b, n)
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=0)


# ------------------------------------------------------------------- build
FAKE_NVCC = """#!{python}
import os, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
src = next((a for a in args if a.endswith(".cu")), None)
if src and os.environ.get("FAKE_NVCC_FAIL", "-") in src:
    sys.exit("error: " + src)
with open(out, "w") as f:
    f.write(" ".join(args))
"""


@pytest.mark.parametrize("fail", [None, "local_corr"])
def test_build_compiles_each_source_into_the_hashed_dir(tmp_path, monkeypatch, fail):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{nvcc.parent}:{os.environ['PATH']}")
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "_build")
    out_dir = kernels.BUILD_ROOT / kernels._source_hash()
    if fail:
        monkeypatch.setenv("FAKE_NVCC_FAIL", fail)
        with pytest.raises(RuntimeError, match="nvcc failed on local_corr.cu"):
            kernels._build(out_dir)
        assert not (out_dir / kernels.LIB_NAME).exists()
        return
    kernels._build(out_dir)
    link = (out_dir / kernels.LIB_NAME).read_text()
    assert "-shared" in link and all(f"{name[:-3]}.{os.getpid()}.o" in link for name in kernels.SOURCES)
    assert all(f"== {name}" in (out_dir / "build.log").read_text() for name in kernels.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in (out_dir / f"oneshot_attention.{os.getpid()}.o").read_text()
