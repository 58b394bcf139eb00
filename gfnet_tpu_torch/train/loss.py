"""Robust multi-scale matching loss.

Counterpart of `gfnet_tpu/train/loss.py` (ref `losses/robust_loss.py`):
  - GT warp from the pair homography with in-bounds mask
    (`robust_loss.py:9-42`, the (n-1) corner-aligned pixel convention);
  - BCE on certainty logits vs the in-bounds mask (`:78`);
  - generalized Charbonnier regression `cs^a * ((epe/cs)^2 + 1)^(a/2)` on
    pixels with gt prob > 0.99 (`:81-82`), α and c from config;
  - per-iteration decay `iteration_base^(n_itr - itr)` (`:78,82`);
  - fine-scale gating: zero supervision where the previous scale's EPE
    (nearest-exact upsampled) exceeds `2/im_size * local_dist[scale] * scale`
    (`:117-120`);
  - PCK@0.5 telemetry per scale (`:72-75`).

The reference's boolean indexing (`epe[prob > 0.99]`) is a masked mean here,
sum(mask * v) / max(sum(mask), 1), as in the JAX package: the same value at
a static shape, with no host synchronization on the mask's count.

Under a mesh (`parallel.mesh.Mesh`), where each rank holds as many rows of
the batch, every mean is the global batch's, as the JAX package's over a
sharded batch: a masked mean all-reduces its numerator and its count, so
the ranks' masks may count differently (the pck telemetry too); the BCE
mean averages the ranks' means.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from gfnet_tpu_torch.core.geometry import normalized_grid, transform_points
from gfnet_tpu_torch.ops.resize import interpolate

Tensor = torch.Tensor


def gt_warp_from_homography(H_s2t: Tensor, src_hw: tuple[int, int], tgt_hw: tuple[int, int],
                            grid_hw: tuple[int, int]) -> tuple[Tensor, Tensor]:
    """GT normalized warp + in-bounds probability (ref `robust_loss.py:9-42`).

    H_s2t: (B, 3, 3) mapping source pixels → target pixels in the
    corner-aligned (n-1) convention the reference uses.
    Returns x2_n (B, gh, gw, 2) and prob (B, gh, gw).
    """
    b = H_s2t.shape[0]
    gh, gw = grid_hw
    x1_n = normalized_grid(gh, gw, device=H_s2t.device).reshape(1, gh * gw, 2).expand(b, -1, -1)
    # ref uses img_src.shape[2]-1 (= h-1) as the scale for both axes (`:25`)
    x1 = (x1_n + 1) * (src_hw[0] - 1) * 0.5
    x2 = transform_points(H_s2t, x1)
    x2_n = ((x2 / (tgt_hw[0] - 1)) * 2 - 1).reshape(b, gh, gw, 2)
    prob = ((x2_n < 1) & (x2_n > -1)).all(-1).to(torch.float32)
    return x2_n, prob


def _global_sums(mesh, total: Tensor, count: Tensor) -> tuple[Tensor, Tensor]:
    """(Σ total, Σ count) over the ranks of `mesh`; as they are without one."""
    if mesh is None:
        return total, count
    sums = mesh.all_reduce(torch.stack([total, count.to(total.dtype)]))
    return sums[0], sums[1]


def _masked_mean(v: Tensor, mask: Tensor, mesh=None) -> Tensor:
    total, count = _global_sums(mesh, (v * mask).sum(), mask.sum())
    return total / count.clamp_min(1.0)


def _mean(v: Tensor, mesh=None) -> Tensor:
    """The mean over the global batch: the ranks' means averaged, as every
    rank holds as many rows."""
    if mesh is None:
        return v.mean()
    return mesh.all_reduce(v.mean()) / mesh.size


def sigmoid_bce(logits: Tensor, labels: Tensor) -> Tensor:
    """binary_cross_entropy_with_logits, numerically stable."""
    return logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


@dataclasses.dataclass(frozen=True)
class RobustLoss:
    """Callable loss over corresps pyramids (ref `RobustLosses`, train-time
    hyperparameters from `train.py:98-106`)."""

    ce_weight: float = 0.01
    alpha: float = 0.5
    c: float = 1e-4
    iteration_base: float = 1.0
    local_largest_scale: int = 8
    local_dist: Any = None  # {1:4, 2:4, 4:8, 8:8}
    im_size: int = 448

    def __call__(self, corresps: dict, H_s2t: Tensor, src_hw: tuple[int, int],
                 tgt_hw: tuple[int, int], mesh=None) -> tuple[Tensor, dict[str, Tensor]]:
        local_dist = self.local_dist or {1: 4, 2: 4, 4: 8, 8: 8}
        tot = 0.0
        metrics: dict[str, Tensor] = {}
        prev_epe = None
        for scale_str in corresps.keys():
            scale = int(scale_str)
            itrs = sorted(corresps[scale_str].keys())
            _, gh, gw, _ = corresps[scale_str][itrs[0]]["flow"].shape
            x2, prob = gt_warp_from_homography(H_s2t, src_hw, tgt_hw, (gh, gw))

            if self.local_largest_scale >= scale and prev_epe is not None:
                gate = interpolate(prev_epe[..., None], (gh, gw), "nearest-exact")[..., 0]
                prob = prob * (gate < (2 / self.im_size) * (local_dist[scale] * scale)).to(prob.dtype)

            ce_loss = 0.0
            reg_loss = 0.0
            n_itr = len(itrs)
            sup_mask = (prob > 0.99).to(torch.float32)
            cs = self.c * scale
            a = self.alpha
            for itr in itrs:
                flow = corresps[scale_str][itr]["flow"].float()
                cert = corresps[scale_str][itr]["certainty"].float()
                epe = torch.linalg.vector_norm(flow - x2, dim=-1)  # (B, gh, gw)
                decay = self.iteration_base ** (n_itr - itr)
                ce_loss = ce_loss + decay * _mean(sigmoid_bce(cert[..., 0], prob), mesh)
                charb = cs**a * ((epe / cs) ** 2 + 1.0) ** (a / 2)
                reg_loss = reg_loss + decay * _masked_mean(charb, sup_mask, mesh)
                if itr == n_itr:
                    num_px = self.im_size / scale
                    pck = _masked_mean((epe < 0.5 * (2 / num_px)).to(torch.float32), sup_mask, mesh)
                    metrics[f"train_pck_05_scale_{scale}"] = pck
                    prev_epe = epe.detach()

            metrics[f"certainty_loss_{scale}"] = ce_loss
            metrics[f"regression_loss_{scale}"] = reg_loss
            tot = tot + self.ce_weight * ce_loss + reg_loss
        metrics["total_loss"] = tot
        return tot, metrics
