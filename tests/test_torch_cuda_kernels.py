"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the dataset path's device ops against the same ops on the CPU.

Marked `cuda`: they skip where there is no GPU. The file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import dataclasses
import math

import pytest
import torch

from gfnet_tpu_torch.data import augment
from gfnet_tpu_torch.eval.flows import kernel_flow
from gfnet_tpu_torch.ops import kernels
from gfnet_tpu_torch.ops.kde import kde, kde_plain
from gfnet_tpu_torch.ops.attention import (entropy_invariant_scale, fused_attention,
                                           scaled_dot_product_attention, streamed_attention_plain)
from gfnet_tpu_torch.ops.local_correlation import (_local_correlation_patch, corr_tile_boxes,
                                                   local_corr_dq_plain, local_corr_dq_tiled_plain,
                                                   local_corr_tiled_plain, local_correlation)
from gfnet_tpu_torch.ops.residual_norm import residual_norm, residual_norm_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,nk,h,d", [
    (2, 1025, 1025, 16, 64), (1, 130, 77, 2, 64), (2, 130, 130, 2, 16), (2, 1024, 1024, 8, 8),
    (2, 1601, 1601, 16, 64), (2, 1600, 1600, 8, 8),  # the 560² pass
    (2, 1000, 1090, 3, 16),                          # kv in more than one shared-memory chunk at D=16
    (1, 77, 130, 2, 8), (1, 200, 2100, 1, 8),        # nq != nk; kv in two chunks at D=8
    (1, 7, 7, 2, 64), (1, 7, 7, 2, 8),               # below one tile
    (16, 1025, 1025, 16, 64),                        # more blocks than one wave holds
    (2, 1024, 1024, 2, 32), (2, 1024, 1024, 1, 128),  # nhead 2 over 64 channels; nhead 1 over 128
    (1, 130, 600, 2, 32), (1, 1000, 1090, 2, 128),    # kv in several shared-memory chunks
    (1, 7, 7, 2, 128), (1, 77, 130, 3, 32),           # below one tile; nq != nk
    (2, 1024, 1024, 8, 12), (1, 130, 77, 2, 20), (1, 200, 300, 2, 100),  # padded to 16, 32, 128
    (2, 1024, 1024, 1, 256), (1, 130, 77, 2, 200),    # D = 256 (kv split), and padded to it
    (2, 1024, 1024, 1, 320), (1, 77, 130, 2, 512),    # above 256: bf16 wide kernel, float32 column groups
    (1, 200, 2100, 1, 128), (2, 1024, 1024, 1, 128),  # kv split over more ranges than one tile each
    (2, 1024, 1024, 1, 384), (2, 1024, 1024, 1, 512),  # wide: 3 + 3 and 4 + 4 boxes of v, kv split
    (16, 1024, 1024, 1, 320), (1, 77, 130, 2, 300),   # wide: 256 blocks, no split; q, k and v padded to 320
    (1, 77, 130, 2, 576), (1, 77, 130, 1, 1024),      # wide: two slabs (8 + 1 boxes; 8 + 8), Q resident
    (1, 130, 200, 1, 1536),                           # wide: Q's boxes stream through the ring
])
def test_oneshot_attention_matches_plain(cuda_device, dtype, b, n, nk, h, d):
    gen = torch.Generator(cuda_device).manual_seed(0)
    q = torch.randn((b, n, h, d), generator=gen, device=cuda_device).to(dtype)
    k, v = (torch.randn((b, nk, h, d), generator=gen, device=cuda_device).to(dtype) for _ in range(2))
    scale = entropy_invariant_scale(d, n, 1024)
    got = kernels.oneshot_attention(q, k, v, scale).float()
    want = scaled_dot_product_attention(q.float(), k.float(), v.float(), scale)
    # bf16: output and PV operands rounded to 8 bits; float32: summation order
    # and the ~2^-22 of each product that three TF32 passes drop
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [64, 8, 32, 128, 12, 320, 512])
def test_oneshot_attention_reads_strided_qkv(cuda_device, d):
    """q, k, v as slices of one fused projection, read in place (above 256
    by the wide kernel's tensor maps over the strided tokens)."""
    gen = torch.Generator(cuda_device).manual_seed(1)
    qkv = torch.randn((2, 300, 3, 4, d), generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = kernels.oneshot_attention(q, k, v, 0.125).float()
    want = scaled_dot_product_attention(q.float(), k.float(), v.float(), 0.125)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("b,n,nk,h,d", [(2, 1601, 1601, 16, 64), (2, 1600, 1600, 8, 8), (1, 130, 77, 2, 16),
                                         (2, 1024, 1024, 2, 32), (1, 300, 700, 1, 128),
                                         (2, 1024, 1024, 1, 320), (1, 77, 130, 2, 384), (1, 130, 77, 2, 512),
                                         (16, 1024, 1024, 1, 320)])
def test_oneshot_attention_matches_its_streamed_plain_version(cuda_device, b, n, nk, h, d):
    """The bf16 kernels against the PyTorch function that repeats their
    schedule in bf16 (above D = 256 the logits box by box): closer than
    against the float32 reference."""
    gen = torch.Generator(cuda_device).manual_seed(3)
    q = torch.randn((b, n, h, d), generator=gen, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn((b, nk, h, d), generator=gen, device=cuda_device).to(torch.bfloat16) for _ in range(2))
    scale = entropy_invariant_scale(d, n, 1024)
    got = kernels.oneshot_attention(q, k, v, scale).float()
    want = streamed_attention_plain(q, k, v, scale, box=64 if d > 256 else None).float()
    # the order of float32 sums and the last bit of ex2: one rounding of the bf16 output
    torch.testing.assert_close(got, want, rtol=2**-7, atol=2**-7)


@pytest.mark.parametrize("dtype,widths", [
    (torch.bfloat16, {8: "mma_kernel<8>", 12: "mma_kernel<16>", 32: "mma_kernel<32>", 64: "wgmma_kernel<64>",
                      200: "wgmma_kernel<256>", 300: "wide_kernel", 512: "wide_kernel"}),
    (torch.float32, {8: "tf32x3_kernel<8, 8>", 100: "tf32x3_kernel<128, 128>", 256: "tf32x3_kernel<256, 256>",
                     300: "tf32x3_kernel<0, 256>"}),
])
def test_oneshot_attention_reports_the_kernel_it_launched(cuda_device, dtype, widths):
    """Each call is counted under the CUDA kernel the library reports it
    launched: the instantiated head dim that holds D, above 256 the wide
    kernel in bf16 and float32's column groups."""
    for d, kernel in widths.items():
        q = torch.randn((1, 70, 2, d), device=cuda_device).to(dtype)
        kernels.reset_launch_counts()
        kernels.oneshot_attention(q, q, q, d**-0.5)
        assert kernels.k1_kernel_counts() == {f"oneshot_attention_{kernel}": 1}, d


@pytest.mark.parametrize("d", [64, 8])
def test_oneshot_attention_refuses_misaligned_bf16_d64(cuda_device, d):
    """The tensor-core paths read 16-byte vectors; they raise on a layout they cannot read."""
    buf = torch.zeros(1 + 2 * 40 * 2 * d, dtype=torch.bfloat16, device=cuda_device)
    q = buf[1:].view(2, 40, 2, d)  # 2 bytes past an aligned address
    with pytest.raises(ValueError, match="16-byte"):
        kernels.oneshot_attention(q, q, q, 0.125)
    ok = torch.zeros((2, 40, 2, d), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="positive scale"):
        kernels.oneshot_attention(ok, ok, ok, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_oneshot_attention_pads_a_head_dim_in_one_launch_at_any_width(cuda_device, dtype):
    """D = 12 runs the D = 16 kernel on zero-padded copies, D = 129 the D =
    256 kernel and D = 300 two column groups (q, k padded to 320, v to 512),
    each counted as one call."""
    gen = torch.Generator(cuda_device).manual_seed(4)
    for d in (12, 129, 300):
        q, k, v = (torch.randn((1, 64, 2, d), generator=gen, device=cuda_device).to(dtype) for _ in range(3))
        before = kernels.launch_counts()["oneshot_attention"]
        got = kernels.oneshot_attention(q, k, v, 0.3)
        assert kernels.launch_counts()["oneshot_attention"] == before + 1
        assert got.shape == q.shape and got.is_contiguous()
        want = scaled_dot_product_attention(q.float(), k.float(), v.float(), 0.3)
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius,g,hw,c", [(7, 32, 32, 64), (2, 40, 70, 16), (1, 5, 9, 8)])
def test_local_corr_matches_plain(cuda_device, dtype, radius, g, hw, c):
    gen = torch.Generator(cuda_device).manual_seed(0)
    q = torch.randn((2, g, g, c), generator=gen, device=cuda_device).to(dtype)
    t = torch.randn((2, hw, hw, c), generator=gen, device=cuda_device).to(dtype)
    fl = torch.rand((2, g, g, 2), generator=gen, device=cuda_device) * 2.4 - 1.2
    fl[0, 0, 0] = math.nan
    got = kernels.local_corr(q, t, fl, radius)
    # same storage-rounded inputs both sides, float32 accumulation
    torch.testing.assert_close(got, _local_correlation_patch(q, t, fl, radius), rtol=2e-3, atol=2e-3)
    assert torch.count_nonzero(got[0, 0, 0]) == 0


@pytest.mark.parametrize("target_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius,g,hw,c", [(7, 32, 32, 64), (2, 40, 70, 16), (1, 5, 9, 8), (3, 6, 11, 24)])
def test_local_corr_bwd_matches_plain(cuda_device, target_dtype, radius, g, hw, c):
    gen = torch.Generator(cuda_device).manual_seed(0)
    grad = torch.randn((2, g, g, (2 * radius + 1) ** 2), generator=gen, device=cuda_device)
    t = torch.randn((2, hw, hw, c), generator=gen, device=cuda_device).to(target_dtype)
    fl = torch.rand((2, g, g, 2), generator=gen, device=cuda_device) * 2.4 - 1.2
    fl[0, 0, 0] = math.nan
    fl[1, 0, 0] = 5.0
    got = kernels.local_corr_bwd(grad, t, fl, radius)
    # the same storage-rounded target both sides, float32 sums in another order
    torch.testing.assert_close(got, local_corr_dq_plain(grad, t, fl, radius), rtol=1e-4, atol=1e-4)
    assert torch.count_nonzero(got[0, 0, 0]) == 0 and torch.count_nonzero(got[1, 0, 0]) == 0


def test_local_corr_bwd_refuses_a_strided_gradient(cuda_device):
    """The gradient that autograd hands over is a slice of a concatenation's;
    the launcher takes it contiguous only, the `Function` makes it so."""
    wide = torch.zeros((1, 4, 4, 30), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.local_corr_bwd(wide[..., 5:30], torch.zeros((1, 6, 6, 8), device=cuda_device),
                               torch.zeros((1, 4, 4, 2), device=cuda_device), 2)


def test_local_correlation_function_matches_plain_gradient(cuda_device):
    """K2 forward and K3 backward through autograd against the plain patch
    version under autograd, with a strided incoming gradient and no gradient
    to target or flow."""
    gen = torch.Generator(cuda_device).manual_seed(1)
    q = torch.randn((2, 6, 6, 8), generator=gen, device=cuda_device)
    t = torch.randn((2, 10, 10, 8), generator=gen, device=cuda_device)
    fl = torch.rand((2, 6, 6, 2), generator=gen, device=cuda_device) * 2.2 - 1.1
    mix = torch.randn((30, 30), generator=gen, device=cuda_device)
    grads = []
    for fn in (local_correlation, _local_correlation_patch):
        before = kernels.launch_counts()
        qq, tt, ff = (x.clone().requires_grad_() for x in (q, t, fl))
        corr = fn(qq, tt.detach() if fn is _local_correlation_patch else tt,
                  ff.detach() if fn is _local_correlation_patch else ff, 2)
        # a concatenation, so that the gradient reaching `corr` is a strided slice
        torch.cat([qq[..., :5], corr], dim=-1).matmul(mix).sin().sum().backward()
        assert tt.grad is None and ff.grad is None
        grads.append(qq.grad)
        launched = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        want = {"oneshot_attention": 0, "local_corr": 1, "local_corr_bwd": 1, "kde": 0, "residual_norm": 0}
        assert launched == (want if fn is local_correlation else dict.fromkeys(want, 0))
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-4)


def test_fused_attention_function_matches_plain_gradient(cuda_device):
    """K1 forward with the backward recomputed through the plain version."""
    gen = torch.Generator(cuda_device).manual_seed(2)
    q, k, v, g = (torch.randn((2, 70, 2, 8), generator=gen, device=cuda_device) for _ in range(4))
    grads = []
    for fn in (fused_attention, scaled_dot_product_attention):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, 0.4), leaves, g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# (radius, C, target side, grid side, batch, dtype): the train step's four
# shapes (float32, 8 pairs) and the slowest inference shape (bf16, one pair)
CORR_MAIN_SHAPES = [(7, 64, 32, 32, 8, torch.float32), (6, 64, 56, 32, 8, torch.float32),
                    (4, 32, 112, 64, 8, torch.float32), (2, 16, 224, 128, 8, torch.float32),
                    (6, 64, 70, 40, 2, torch.bfloat16)]


@pytest.mark.parametrize("kind", ["homography", "random", "mixed"])
@pytest.mark.parametrize("radius,c,t,g,b,dtype", CORR_MAIN_SHAPES)
def test_local_corr_tiles_match_plain(cuda_device, kind, radius, c, t, g, b, dtype):
    """K2 and K3 at the main path's shapes on flows that take the staged
    branch, the per-cell branch, or both, against the plain versions and
    against the plain versions of their schedule."""
    gen = torch.Generator(cuda_device).manual_seed(5)
    q = torch.randn((b, g, g, c), generator=gen, device=cuda_device).to(dtype)
    tg = torch.randn((b, t, t, c), generator=gen, device=cuda_device).to(dtype)
    grad = torch.randn((b, g, g, (2 * radius + 1) ** 2), generator=gen, device=cuda_device)
    fl = kernel_flow(kind, b, g, t, 6).to(cuda_device)
    sched = kernels.corr_schedule(radius, c, tg.element_size(), t, t, g, g, b, True)
    sched3 = kernels.corr_schedule(radius, c, tg.element_size(), t, t, g, g, b, False)
    _, staged = corr_tile_boxes(fl.cpu(), t, t, radius, sched.tile, sched.box)
    share = staged.float().mean().item()
    assert {"homography": share > 0.85, "random": share == 0.0, "mixed": 0.0 < share < 1.0}[kind], share
    out = kernels.local_corr(q, tg, fl, radius)
    dq = kernels.local_corr_bwd(grad, tg, fl, radius)
    # the same storage-rounded inputs both sides, float32 sums in another order
    torch.testing.assert_close(out, _local_correlation_patch(q, tg, fl, radius), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dq, local_corr_dq_plain(grad, tg, fl, radius), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out, local_corr_tiled_plain(q, tg, fl, radius, sched.tile, sched.box),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dq, local_corr_dq_tiled_plain(grad, tg, fl, radius, sched3.tile, sched3.box),
                               rtol=1e-4, atol=1e-4)
    bad = ~torch.isfinite(fl).all(-1) | (fl.abs() > 2).any(-1)
    assert torch.count_nonzero(out[bad]) == 0 and torch.count_nonzero(dq[bad]) == 0


@pytest.mark.parametrize("kind", ["homography", "random", "mixed"])
def test_local_corr_bwd_is_bitwise_repeatable(cuda_device, kind):
    gen = torch.Generator(cuda_device).manual_seed(8)
    b, g, t, c, radius = 8, 32, 56, 64, 6
    tg = torch.randn((b, t, t, c), generator=gen, device=cuda_device)
    grad = torch.randn((b, g, g, (2 * radius + 1) ** 2), generator=gen, device=cuda_device)
    fl = kernel_flow(kind, b, g, t, 9).to(cuda_device)
    first = kernels.local_corr_bwd(grad, tg, fl, radius)
    assert torch.equal(first, kernels.local_corr_bwd(grad, tg, fl, radius))


@pytest.mark.parametrize("radius,c,t,g,b,dtype", CORR_MAIN_SHAPES)
def test_local_corr_with_staging_off_matches_plain(cuda_device, radius, c, t, g, b, dtype):
    """The same tiles with a box of one window, so that the cells read their
    patches from global memory, on a homography flow: the schedule override
    the benchmark times staging against."""
    gen = torch.Generator(cuda_device).manual_seed(10)
    q = torch.randn((b, g, g, c), generator=gen, device=cuda_device).to(dtype)
    tg = torch.randn((b, t, t, c), generator=gen, device=cuda_device).to(dtype)
    grad = torch.randn((b, g, g, (2 * radius + 1) ** 2), generator=gen, device=cuda_device)
    fl = kernel_flow("homography", b, g, t, 11).to(cuda_device)
    win, elem = 2 * radius + 2, tg.element_size()
    offs = [kernels.corr_layout(radius, c, elem, s.tile, (win, win), s.chunk, rows)
            for s, rows in ((kernels.corr_schedule(radius, c, elem, t, t, g, g, b, rows), rows)
                            for rows in (True, False))]
    assert corr_tile_boxes(fl.cpu(), t, t, radius, offs[0].tile, offs[0].box)[1].float().mean() < 0.1
    torch.testing.assert_close(kernels.local_corr(q, tg, fl, radius, offs[0]),
                               _local_correlation_patch(q, tg, fl, radius), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kernels.local_corr_bwd(grad, tg, fl, radius, offs[1]),
                               local_corr_dq_plain(grad, tg, fl, radius), rtol=1e-4, atol=1e-4)


def test_local_corr_refuses_a_layout_too_small(cuda_device):
    """The launcher checks that each area of the layout it is handed holds
    what the kernel writes there: K3's layout has no room for K2's query rows."""
    q = torch.zeros((2, 32, 32, 64), dtype=torch.bfloat16, device=cuda_device)
    fl = torch.zeros((2, 32, 32, 2), device=cuda_device)
    k3_layout = kernels.corr_schedule(7, 64, 2, 32, 32, 32, 32, 2, False)
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.local_corr(q, q, fl, 7, k3_layout)


def test_local_correlation_pads_channels_tma_cannot_stage(cuda_device):
    """`local_correlation` zero-pads a pixel that is not a multiple of 16
    bytes (bf16 C = 12 and 4, float32 C = 6) and launches K2 and K3 with the
    caller's 1/√C, dq sliced back; the kernels themselves refuse such a pixel,
    and a target that is not 16-byte aligned."""
    gen = torch.Generator(cuda_device).manual_seed(5)
    for dtype, c in ((torch.bfloat16, 12), (torch.bfloat16, 4), (torch.float32, 6)):
        q = torch.randn((2, 10, 10, c), generator=gen, device=cuda_device).to(dtype).requires_grad_()
        t = torch.randn((2, 20, 20, c), generator=gen, device=cuda_device).to(dtype)
        fl = torch.rand((2, 10, 10, 2), generator=gen, device=cuda_device) * 2.2 - 1.1
        before = kernels.launch_counts()
        got = local_correlation(q, t, fl, 2)
        got.backward(torch.ones_like(got))
        after = kernels.launch_counts()
        assert after["local_corr"] == before["local_corr"] + 1
        assert after["local_corr_bwd"] == before["local_corr_bwd"] + 1
        torch.testing.assert_close(got, _local_correlation_patch(q.detach(), t, fl, 2), rtol=1e-4, atol=1e-4)
        assert q.grad.shape == q.shape
        want_dq = local_corr_dq_plain(torch.ones_like(got), t, fl, 2).to(dtype).float()
        torch.testing.assert_close(q.grad.float(), want_dq, rtol=1e-2, atol=1e-2)
    q = torch.zeros((1, 4, 4, 4), dtype=torch.bfloat16, device=cuda_device)
    fl = torch.zeros((1, 4, 4, 2), device=cuda_device)
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.local_corr(q, torch.zeros((1, 8, 8, 4), dtype=torch.bfloat16, device=cuda_device), fl, 1)
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.local_corr_bwd(torch.zeros((1, 4, 4, 9), device=cuda_device),
                               torch.zeros((1, 8, 8, 4), dtype=torch.bfloat16, device=cuda_device), fl, 1)
    buf = torch.zeros(1 + 8 * 8 * 8, device=cuda_device)
    shifted = buf[1:].view(1, 8, 8, 8)  # 4 bytes past an aligned address
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.local_corr(torch.zeros((1, 4, 4, 8), device=cuda_device), shifted, fl, 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.local_corr_bwd(torch.zeros((1, 4, 4, 9), device=cuda_device), shifted, fl, 1)


# ------------------------------------------------------------- K4, the KDE
def clustered_points(seed: int, b: int, n: int, device) -> torch.Tensor:
    """(b, n, 4) points in [-1, 1]: clusters of 1 to 40 points 0.03 apart
    around uniform centres, so that densities run from 1 to about 30, on both
    sides of the sampler's `density < 10` cut."""
    gen = torch.Generator().manual_seed(seed)
    owner = torch.repeat_interleave(torch.arange(n), torch.randint(1, 41, (n,), generator=gen))[:n]
    centres = torch.rand((b, n, 4), generator=gen) * 2 - 1
    return (centres[:, owner] + torch.randn((b, n, 4), generator=gen) * 0.03).clamp(-1, 1).to(device)


@pytest.mark.parametrize("n", [1, 37, 4097, 20000])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_kde_matches_plain(cuda_device, b, n):
    x = clustered_points(b * 100_000 + n, b, n, cuda_device)
    before = kernels.launch_counts()["kde"]
    got = kde(x)
    assert kernels.launch_counts()["kde"] == before + 1
    want = kde_plain(x)
    if n > 4096:
        assert bool((want < 10).any()) and bool((want > 10).any())
    if n == 20000:  # the sampler's: ATen's order of the plain path's row sum, so bit for bit
        assert torch.equal(got, want)
    # the plain path's float32 terms, in another order of the sum. At N = 1 the
    # density is the point's own term alone, exp(−50·d²) with d² what rounding
    # leaves of sq + sq − 2·dot, and cuBLAS forms the (B, 1, 4)·(B, 4, 1)
    # product with another kernel than the GEMM of larger N, whose dot may lie
    # an ulp off the FMA chain's: 2·50·ulp(sq) of the density (read 1.2e-5).
    # The tolerance there is two such ulps.
    sq_max = (x * x).sum(-1).max().item()
    rtol = 1e-5 if n > 1 else 2 * 2 * 50 * torch.finfo(torch.float32).eps * max(sq_max, 1.0)
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("b", [1, 8])
def test_kde_is_bitwise_repeatable(cuda_device, b):
    x = clustered_points(5, b, 20000, cuda_device)
    assert torch.equal(kde(x), kde(x))


def test_kde_routes_or_refuses_other_inputs(cuda_device):
    """`kde` hands K4 one contiguous, aligned float32 copy of a strided,
    misaligned, bf16 or float64 input, and of one member without a batch
    dim; D = 3 on the card raises, never takes the plain path. K4 itself
    refuses what it cannot read."""
    x = clustered_points(3, 2, 3000, cuda_device)
    strided = torch.cat([x, torch.zeros_like(x)], -1)[..., :4]
    assert not strided.is_contiguous()
    misaligned = torch.empty(x.numel() + 1, device=cuda_device)[1:].view(x.shape).copy_(x)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16
    for y in (strided, misaligned, x.to(torch.bfloat16), x.double(), x[1]):
        before = kernels.launch_counts()["kde"]
        got = kde(y)
        assert kernels.launch_counts()["kde"] == before + 1 and got.dtype == torch.float32
        torch.testing.assert_close(got, kde_plain(y), rtol=1e-5, atol=0)
    before = kernels.launch_counts()["kde"]
    with pytest.raises(ValueError, match="shapes"):
        kde(x[..., :3])
    assert kernels.launch_counts()["kde"] == before
    sq = (x * x).sum(-1)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.kde(strided, (strided * strided).sum(-1), -50.0)
    with pytest.raises(ValueError, match="aligned"):
        kernels.kde(misaligned, sq, -50.0)
    with pytest.raises(ValueError, match="float32"):
        kernels.kde(x.double(), sq.double(), -50.0)
    with pytest.raises(ValueError, match="shapes"):
        kernels.kde(x[..., :3].contiguous(), sq, -50.0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.kde(x.cpu(), sq.cpu(), -50.0)


def test_sample_core_launches_kde_once(cuda_device):
    from gfnet_tpu_torch.config import tiny_test_config
    from gfnet_tpu_torch.matcher import GFNetMatcher

    m = GFNetMatcher(tiny_test_config(), device="cuda", dtype=torch.float32)
    gen = torch.Generator(cuda_device).manual_seed(4)
    b, n, num = 2, 3000, 200
    matches = torch.rand((b, n, 4), generator=gen, device=cuda_device) * 2 - 1
    certainty, u_good = (torch.rand((b, n), generator=gen, device=cuda_device).clamp_min(1e-20) for _ in range(2))
    u_bal = torch.rand((b, 4 * num), generator=gen, device=cuda_device).clamp_min(1e-20)
    kernels.reset_launch_counts()
    got, _ = m._sample_core(matches, certainty, num, u_good, u_bal)
    assert kernels.launch_counts()["kde"] == 1 and got.shape == (b, num, 4)


# ------------------------------------------- K5, the ViT's residual stream
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("use", ["add", "add_norm", "norm"])
@pytest.mark.parametrize("rows,d", [(16 * 1029, 1024), (16 * 1605, 1536), (2 * 1029, 1024), (37, 32)])
def test_residual_norm_matches_plain(cuda_device, rows, d, use, dtype):
    """K5 against the plain path on the card: s bit for bit; n in bf16 within
    one ulp everywhere, plus float32 rounding of the norm's terms where they
    cancel, and off on under 1% of elements (the float32 norm sums in another
    order, which moves a value across a rounding boundary only where it lay
    next to one: `chip_smoke.k5_norm_error`), in float32 within its rounding."""
    import chip_smoke

    t = chip_smoke.k5_inputs(torch, rows, d, dtype, cuda_device)
    kw = {k: t[k] for k in chip_smoke.K5_USES[use]}
    before = kernels.launch_counts()["residual_norm"]
    with torch.no_grad():
        s, n = residual_norm(**kw)
        want_s, want_n = residual_norm_plain(**kw)
    assert kernels.launch_counts()["residual_norm"] == before + 1
    assert torch.equal(s, want_s) and s.dtype == dtype
    if use == "add":
        assert n is None
        return
    assert n.dtype == dtype and n.shape == (rows, d)
    if dtype == torch.float32:
        torch.testing.assert_close(n, want_n, rtol=1e-5, atol=1e-5)
        return
    err = chip_smoke.k5_norm_error(torch, n, want_n, want_s, t["weight"], t["bias"])
    assert err["k5_ok"], err


def test_residual_norm_refuses_what_it_cannot_read(cuda_device):
    import chip_smoke

    t = chip_smoke.k5_inputs(torch, 64, 1024, torch.bfloat16, cuda_device)
    x, h, g, w, b = (t[k] for k in ("x", "h", "gamma", "weight", "bias"))
    strided = torch.empty((64, 2048), dtype=x.dtype, device=cuda_device)[:, :1024].copy_(x)
    misaligned = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda_device)[1:1 + x.numel()].view(x.shape)
    for bad, match in ((dict(x=strided), "contiguous"), (dict(h=strided), "contiguous"),
                       (dict(x=misaligned.copy_(x)), "aligned"), (dict(x=x.float()), "dtypes"),
                       (dict(x=x.double(), h=h.double(), gamma=g.double(), weight=w.double(), bias=b.double()),
                        "dtypes"),
                       (dict(x=x[:, :36].contiguous(), h=h[:, :36].contiguous(), gamma=g[:36].contiguous(),
                             weight=w[:36].contiguous(), bias=b[:36].contiguous()), "D = 36"),
                       (dict(x=x.clone().requires_grad_()), "no backward"), (dict(gamma=None), "give h")):
        args = {**dict(x=x, h=h, gamma=g, weight=w, bias=b), **bad}
        before = kernels.launch_counts()["residual_norm"]
        with pytest.raises(ValueError, match=match):
            kernels.residual_norm(**args)
        assert kernels.launch_counts()["residual_norm"] == before
    with pytest.raises(ValueError, match="CUDA"):
        kernels.residual_norm(x.cpu(), weight=w.cpu(), bias=b.cpu())


def test_a_vit_forward_runs_every_block_through_k5(cuda_device, monkeypatch):
    """One ViT-L forward on the card (bf16, default weights): three K5
    launches a block and one for the final norm, and the tokens within bf16
    rounding of the same ViT on the plain path."""
    from gfnet_tpu_torch.config import DinoConfig
    from gfnet_tpu_torch.models import vit as vit_module

    cfg = DinoConfig()
    torch.manual_seed(0)
    vit = vit_module.VisionTransformer(cfg, dtype=torch.bfloat16).to(cuda_device, torch.bfloat16)
    vit = vit.eval().requires_grad_(False)
    with torch.no_grad():  # the patch embedding is left uninitialised, the position embedding zero
        vit.patch_embed.proj.weight.normal_(0.0, 0.02)
        vit.pos_embed.normal_(0.0, 0.02)
    img = torch.rand((2, 224, 224, 3), generator=torch.Generator(cuda_device).manual_seed(1), device=cuda_device)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = vit(img).float()
    assert kernels.launch_counts()["residual_norm"] == 3 * cfg.depth + 1
    monkeypatch.setattr(vit_module, "residual_norm", residual_norm_plain)
    with torch.no_grad():
        want = vit(img).float()
    assert kernels.launch_counts()["residual_norm"] == 3 * cfg.depth + 1
    assert torch.isfinite(got).all()
    assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) < 2e-2


# --------------------------------------------- the dataset path on the card
def _texture_u8(seed: int, h: int, w: int) -> torch.Tensor:
    from gfnet_tpu_torch.eval.synthetic import make_texture, to_uint8

    tex = make_texture(__import__("numpy").random.default_rng(seed), max(h, w))
    return to_uint8(tex[:h, :w])


AUGMENT_OPS = {
    "brightness": lambda im: augment.brightness(im, 1.3),
    "contrast": lambda im: augment.contrast(im, 0.6),
    "saturation": lambda im: augment.saturation(im, 1.5),
    "hue": lambda im: augment.hue(im, -0.17),
    "gray": lambda im: augment.gray_rgb(augment.to_gray(im)),
    "blur": lambda im: augment.gaussian_blur(im, 1.7),
    "resize_bilinear": lambda im: augment.resize(im, (130, 97), "bilinear"),
    "resize_bicubic": lambda im: augment.resize(im, (64, 50), "bicubic"),
}


@pytest.mark.parametrize("op", sorted(AUGMENT_OPS))
def test_augmentation_on_the_card_equals_the_cpu(cuda_device, op):
    """The same integer and float arithmetic on both devices: within 1 level."""
    img = _texture_u8(3, 96, 80)
    want = AUGMENT_OPS[op](img)
    got = AUGMENT_OPS[op](img.to(cuda_device)).cpu()
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert (got.int() - want.int()).abs().max() <= 1


def test_pair_synthesis_on_the_card_equals_the_cpu(cuda_device):
    import numpy as np

    from gfnet_tpu_torch.data.homography_synth import random_homography_pair

    a = _texture_u8(4, 150, 170).float() / 255.0
    b = _texture_u8(5, 150, 170).float() / 255.0
    kw = dict(crop_size=120, input_hw=(96, 96), deformation_ratio=0.3, bi=True)
    cpu = random_homography_pair(a, b, rng=np.random.default_rng(1), **kw)
    gpu = random_homography_pair(a.to(cuda_device), b.to(cuda_device), rng=np.random.default_rng(1), **kw)
    np.testing.assert_array_equal(gpu[2], cpu[2])
    for g, c in zip(gpu[:2], cpu[:2]):
        assert (g.cpu() - c).abs().max() <= 1 / 255


def test_val_read_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    import json

    import numpy as np

    from gfnet_tpu_torch.data.dataset import HomographyDataset
    from gfnet_tpu_torch.data.imageio import write_png

    d = tmp_path / "test" / "synth_1k_112x112"
    for sub in ("source", "target", "H_s2t"):
        (d / sub).mkdir(parents=True)
    for i, (h, w) in enumerate(((150, 130), (112, 112))):
        write_png(d / "source" / f"{i:05d}.png", _texture_u8(6 + i, h, w))
        write_png(d / "target" / f"{i:05d}.png", _texture_u8(8 + i, w, h))
        (d / "H_s2t" / f"{i:05d}.json").write_text(json.dumps({"H": np.eye(3).tolist()}))
    kw = dict(dataset="synthetic_tiny", mode="val", data_path=str(tmp_path), input_resolution=(112, 112))
    cpu, gpu = HomographyDataset(**kw, device="cpu"), HomographyDataset(**kw, device=cuda_device)
    for i in range(len(cpu)):
        c, g = cpu[i], gpu[i]
        np.testing.assert_array_equal(g["H_s2t"], c["H_s2t"])
        for k in ("im_A", "im_B"):
            assert g[k].is_cuda and (g[k].cpu() - c[k]).abs().max() <= 1 / 255


def test_a_giant_register_block_matches_the_reference(cuda_device):
    """One block of DINOv2 ViT-g/14-reg at full width (1536, 24 heads of 64,
    the fused SwiGLU FFN, N = 1605: 40² patches, cls and 4 registers) in bf16,
    K1 and all, against the benchmark's plain block in float32 on the same
    bf16-rounded input and weights. Compared: the block's update (output
    minus input), by the norm of the difference over the reference's norm.
    The limit, 2e-2: bf16 keeps 8 bits, a relative rounding of 2^-9 at each
    of the ~6 roundings in a row (LN out, qkv, P in K1, proj, w12, the gate)
    gives ~0.5%, so 2% leaves room; the same reference block on fp8 e4m3
    operands (`numerics.lowered()`, 4 bits) has to read above it."""
    from gfnet_tpu_torch.models.vit import Block
    from portbench.reference import numerics
    from portbench.reference.vit_registers import Block as ReferenceBlock
    from portbench.reference.vit_registers import ViTConfig
    from portbench.weights_vitreg import draw_vit

    cfg = ViTConfig(depth=1)
    drawn = draw_vit(dataclasses.asdict(cfg))
    state = {k[len("blocks.0."):]: v.to(torch.bfloat16) for k, v in drawn.items() if k.startswith("blocks.0.")}
    block = Block(1536, 24, 4.0, 1.0, "swiglufused", torch.bfloat16)
    block.load_state_dict(state)
    block = block.to(cuda_device, torch.bfloat16).eval()
    ref = ReferenceBlock(cfg)
    ref.load_state_dict({k: v.float() for k, v in state.items()})
    ref = ref.to(cuda_device).eval()
    gen = torch.Generator(cuda_device).manual_seed(0)
    x = torch.randn((2, 1605, 1536), generator=gen, device=cuda_device).to(torch.bfloat16)
    with torch.no_grad(), numerics.exact():
        got = block(x).float() - x.float()
        want = ref(x.float()) - x.float()
        with numerics.lowered():
            lowered = ref(x.float()) - x.float()
    err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    err_lowered = float(torch.linalg.vector_norm(lowered - want) / torch.linalg.vector_norm(want))
    assert torch.isfinite(got).all() and err < 2e-2 < err_lowered, (err, err_lowered)
