"""Gaussian kernel density estimate over sampled matches.

Counterpart of `gfnet_tpu/ops/kde.py` (ref `utils/kde.py:4-13`), with
leading batch dimensions. CUDA tensors go to K4, `ops/kernels.kde`, which
never writes the N x N scores and takes 4 coordinates (the matches the
sampler scores) and no other D; CPU tensors take `kde_plain`, whose row
dimension runs in blocks so the score matrix never exists whole. Both form
the same float32 d² = (|x_i|² + |x_j|²) − 2·x_i·x_j; only the order of the
row sum differs.
Stays float32: with std=0.1 the exponent is 50·d², and bf16's rounding of
the cross term would swing densities by factors of e^±1.
"""

from __future__ import annotations

import torch

from gfnet_tpu_torch.ops import kernels

Tensor = torch.Tensor


def kde(x: Tensor, std: float = 0.1, block: int = 4096) -> Tensor:
    """density[..., i] = sum_j exp(-|x_i - x_j|² / (2 std²)); x: (..., N, D).
    On the card one K4 call over all leading dims (`block` unused; D other
    than 4 raises); on the CPU `kde_plain`."""
    x = x.to(torch.float32)
    if not x.is_cuda:
        return kde_plain(x, std, block)
    x = x.contiguous()
    if x.data_ptr() % 16:  # K4 reads 16-byte vectors
        x = x.clone()
    sq = (x * x).sum(-1)
    n, d = x.shape[-2:]
    return kernels.kde(x.reshape(-1, n, d), sq.reshape(-1, n), -1.0 / (2 * std * std)).reshape(sq.shape)


def kde_plain(x: Tensor, std: float = 0.1, block: int = 4096) -> Tensor:
    """`kde` in blocks of PyTorch ops. Each step scores `block` rows over the
    whole batch, so a batch of B takes block // B rows of each member at a
    time."""
    x = x.to(torch.float32)
    sq = (x * x).sum(-1)
    inv = -1.0 / (2 * std * std)
    rows = max(1, block // sq[..., 0].numel())
    out = []
    for s in range(0, x.shape[-2], rows):
        xb = x[..., s:s + rows, :]
        d2 = (sq[..., s:s + rows, None] + sq[..., None, :] - 2.0 * (xb @ x.mT)).clamp_min(0.0)
        out.append(torch.exp(d2 * inv).sum(-1))
    return torch.cat(out, dim=-1)
