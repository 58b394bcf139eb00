"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where there is no GPU. The file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import math

import pytest
import torch

from gfnet_tpu_torch.ops import kernels
from gfnet_tpu_torch.ops.attention import entropy_invariant_scale, scaled_dot_product_attention
from gfnet_tpu_torch.ops.local_correlation import _local_correlation_patch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,nk,h,d", [(2, 1025, 1025, 16, 64), (1, 130, 77, 2, 64),
                                        (2, 130, 130, 2, 16), (2, 1024, 1024, 8, 8)])
def test_oneshot_attention_matches_plain(cuda_device, dtype, b, n, nk, h, d):
    gen = torch.Generator(cuda_device).manual_seed(0)
    q = torch.randn((b, n, h, d), generator=gen, device=cuda_device).to(dtype)
    k, v = (torch.randn((b, nk, h, d), generator=gen, device=cuda_device).to(dtype) for _ in range(2))
    scale = entropy_invariant_scale(d, n, 1024)
    got = kernels.oneshot_attention(q, k, v, scale).float()
    want = scaled_dot_product_attention(q.float(), k.float(), v.float(), scale)
    # bf16: output and PV operands rounded to 8 bits; float32: summation order only
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_oneshot_attention_reads_strided_qkv(cuda_device):
    """q, k, v as slices of one fused projection, read in place."""
    gen = torch.Generator(cuda_device).manual_seed(1)
    qkv = torch.randn((2, 300, 3, 4, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = kernels.oneshot_attention(q, k, v, 0.125).float()
    want = scaled_dot_product_attention(q.float(), k.float(), v.float(), 0.125)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


def test_oneshot_attention_refuses_misaligned_bf16_d64(cuda_device):
    """The tensor-core path reads 16-byte vectors; it raises on a layout it cannot read."""
    buf = torch.zeros(1 + 2 * 40 * 2 * 64, dtype=torch.bfloat16, device=cuda_device)
    q = buf[1:].view(2, 40, 2, 64)  # 2 bytes past an aligned address
    with pytest.raises(ValueError, match="16-byte"):
        kernels.oneshot_attention(q, q, q, 0.125)


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
