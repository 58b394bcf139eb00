"""Global correlation volume + softmax position-expectation flow init.

Counterpart of `gfnet_tpu/ops/correlation.py` (ref
`model/network.py:415-440`): the (B, G², G²) similarity of the coarsest
grid's features and the softmax expectation of the target-cell grid, and
its split over the ranks of a mesh (`corr_volume_flow_sharded`).
Features are NHWC (B, H, W, C).
"""

from __future__ import annotations

import math

import torch

from gfnet_tpu_torch.core.geometry import normalized_grid

Tensor = torch.Tensor


def global_correlation(feat0: Tensor, feat1: Tensor) -> Tensor:
    """corr[b, j, i] = <feat1[b, j], feat0[b, i]> / sqrt(C), float32,
    (B, H1*W1, H0*W0) target-major."""
    b, h0, w0, ch = feat0.shape
    _, h1, w1, _ = feat1.shape
    f0 = feat0.reshape(b, h0 * w0, ch).to(torch.float32)
    f1 = feat1.reshape(b, h1 * w1, ch).to(torch.float32)
    return torch.einsum("bjc,bic->bji", f1, f0) / math.sqrt(ch)


def softmax_pos_embed(corr: Tensor, h1: int, w1: int) -> Tensor:
    """Expected target coordinate under the softmax over target cells:
    (B, H1*W1, H0*W0) → flow (B, H0, W0, 2) of normalized xy."""
    b, n1, n0 = corr.shape
    if n1 != h1 * w1:
        raise ValueError(f"corr has {n1} target cells, grid is {h1}x{w1}")
    p = torch.softmax(corr, dim=1)
    grid = normalized_grid(h1, w1, device=corr.device).reshape(n1, 2)
    flow = torch.einsum("bji,jd->bid", p, grid)
    side = int(n0**0.5)
    return flow.reshape(b, side, side, 2)


def corr_volume_flow(feat0: Tensor, feat1: Tensor) -> Tensor:
    """Correlation volume + softmax expectation → initial flow (B, H0, W0, 2)."""
    _, h1, w1, _ = feat1.shape
    return softmax_pos_embed(global_correlation(feat0, feat1), h1, w1)


def corr_volume_flow_sharded(feat0: Tensor, feat1: Tensor, mesh) -> Tensor:
    """`corr_volume_flow` with the target cells split over the ranks of
    `mesh` (`parallel.mesh.Mesh`), every rank holding both views whole
    (`gfnet_tpu/ops/correlation.py:61-131`). Each rank scores its N1/d slice
    of target cells, and the ranks combine a softmax expectation that stays
    stable: the row maximum M over all ranks (all-reduce MAX), then
    s = Σ exp(corr - M) and e = Σ exp(corr - M)·grid (all-reduce SUM), and
    flow = e / s, the same on every rank."""
    b, h0, w0, ch = feat0.shape
    _, h1, w1, _ = feat1.shape
    n1 = h1 * w1
    if n1 % mesh.size:
        raise ValueError(f"{n1} target cells do not split over {mesh.size} ranks")
    rows = mesh.rows(n1)
    f0 = feat0.reshape(b, h0 * w0, ch).to(torch.float32)
    f1 = feat1.reshape(b, n1, ch)[:, rows].to(torch.float32)
    grid = normalized_grid(h1, w1, device=feat0.device).reshape(n1, 2)[rows]
    corr = torch.einsum("bjc,bic->bji", f1, f0) / math.sqrt(ch)
    m = mesh.all_reduce_(corr.detach().amax(dim=1), op="max")
    e = torch.exp(corr - m[:, None, :])
    s = mesh.all_reduce(e.sum(dim=1))
    num = mesh.all_reduce(torch.einsum("bji,jd->bid", e, grid))
    return (num / s[..., None]).reshape(b, h0, w0, 2)
