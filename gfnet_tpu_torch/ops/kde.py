"""Gaussian kernel density estimate over sampled matches.

Counterpart of `gfnet_tpu/ops/kde.py` (ref `utils/kde.py:4-13`), with
leading batch dimensions. The row dimension runs in blocks so the N x N
score matrix never exists whole.
Stays float32: with std=0.1 the exponent is 50·d², and bf16's rounding of
the cross term would swing densities by factors of e^±1.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def kde(x: Tensor, std: float = 0.1, block: int = 4096) -> Tensor:
    """density[..., i] = sum_j exp(-|x_i - x_j|² / (2 std²)); x: (..., N, D).
    Each step scores `block` rows over the whole batch, so a batch of B
    takes block // B rows of each member at a time."""
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
