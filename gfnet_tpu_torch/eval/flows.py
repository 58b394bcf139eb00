"""Synthetic flows for checking and timing the local-correlation kernels.

K2 and K3 (`ops/kernels.py`) give each block a tile of neighbouring cells
and stage the union of their windows where it fits a box, so their speed
depends on the flow: a smooth one, as the refiners see, lets the tiles
stage; a flow drawn independently per cell lets none. `kernel_flow` makes
each of the kinds `chip_smoke.py`, the scripts and the tests use. Needs
numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

from gfnet_tpu_torch.core.geometry import get_perspective_transform, normalized_grid, transform_points

Tensor = torch.Tensor

# "homography": the smooth flow the refiners see, whose tiles stage;
# "random": uniform in [-1.1, 1.1] per cell, the worst case, where no tile
# stages; "staged_only": a milder homography (corners moved by up to 10% of
# the side), where every tile stages; "mixed": a homography with 3% of its
# cells NaN, far outside or random, so that both branches run in one launch.
FLOW_KINDS = ("homography", "random", "staged_only", "mixed")


def homography_flow(rng: np.random.Generator, batch: int, grid: int, target_hw: tuple[int, int],
                    perturb: float = 0.25, jitter: float = 0.5, broken: float = 0.0) -> Tensor:
    """(B, G, G, 2) float32 flow of a homography, as the refiners see it: the
    four corners of the normalized frame moved by up to `perturb` of the side
    (as `data/homography_synth._four_point_warp` perturbs them), the G × G
    cell centres of `normalized_grid` mapped through it, plus independent
    per-cell jitter of up to `jitter` target pixels. A share `broken` of the
    cells, drawn at random, is set in turns to NaN, to a point far outside the
    map, and to a uniform random point of the map (which breaks its tile's
    union)."""
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    moved = corners + rng.uniform(-2 * perturb, 2 * perturb, (batch, 4, 2)).astype(np.float32)
    H = get_perspective_transform(torch.from_numpy(np.broadcast_to(corners, (batch, 4, 2)).copy()),
                                  torch.from_numpy(moved))
    centres = normalized_grid(grid, grid).reshape(1, grid * grid, 2).expand(batch, -1, -1)
    flow = transform_points(H, centres).reshape(batch, grid, grid, 2)
    scale = torch.tensor([2.0 / target_hw[1], 2.0 / target_hw[0]])
    noise = torch.from_numpy(rng.uniform(-jitter, jitter, (batch, grid, grid, 2)).astype(np.float32))
    flow = (flow + noise * scale).float()
    n = int(round(broken * batch * grid * grid))
    if n:
        cells = torch.from_numpy(rng.choice(batch * grid * grid, n, replace=False))
        flat = flow.reshape(-1, 2)
        flat[cells[0::3]] = float("nan")
        flat[cells[1::3]] = 5.0
        flat[cells[2::3]] = torch.from_numpy(rng.uniform(-1, 1, (len(cells[2::3]), 2)).astype(np.float32))
    return flow.contiguous()


def kernel_flow(kind: str, batch: int, grid: int, target_side: int, seed: int) -> Tensor:
    """A (B, G, G, 2) float32 flow of one of `FLOW_KINDS` on the CPU, from `seed`."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return torch.from_numpy(rng.uniform(-1.1, 1.1, (batch, grid, grid, 2)).astype(np.float32))
    if kind not in FLOW_KINDS:
        raise ValueError(f"flow kind {kind!r} not in {FLOW_KINDS}")
    return homography_flow(rng, batch, grid, (target_side, target_side),
                           perturb=0.1 if kind == "staged_only" else 0.25,
                           broken=0.03 if kind == "mixed" else 0.0)
