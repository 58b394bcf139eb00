"""The reference matcher: two passes of ViT + head, the warp stitch, the
threshold-balanced sampling under JAX's keys, and RANSAC + IRLS.

`Reference(cfg, vit_state, head_state, device)` loads the same state dicts
as the program. `match` gives a batch's dense warp and certainty, and
`sample_solve` the homographies from a warp and certainty under the pairs'
keys.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import keys as K
from portbench.reference import numerics
from portbench.reference.models import GFNet, VisionTransformer
from portbench.reference.ops import (denormalize_corner_aligned, interpolate, kde, normalized_grid,
                                     ransac_homography_from_indices)

Tensor = torch.Tensor

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NUM_HYPOTHESES = 512
GUMBEL_MIN = 1e-20


def topk_indices(x: Tensor, k: int) -> Tensor:
    """The k largest entries' indices along the last axis, largest first,
    ties to the lower index (`jax.lax.top_k`'s order): one int64 key an
    entry, the float's bits made monotonic above N - 1 - index."""
    bits = x.float().view(torch.int32).to(torch.int64)
    monotonic = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    n = x.shape[-1]
    rank = torch.arange(n - 1, -1, -1, device=x.device)
    return torch.topk(monotonic * (1 << 32) + rank, k, dim=-1).indices


def upsample_grid_schedule(upsample_res, patch: int = 14) -> tuple[int, ...]:
    g0 = int(upsample_res[0] / patch)
    return (g0, 2 * g0, 4 * g0, 8 * g0)


class Reference:
    """The model in float32 on `device`, from the program's state dicts."""

    def __init__(self, cfg, vit_state: dict, head_state: dict, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.vit = VisionTransformer(cfg.dino)
        self.vit.load_state_dict({k: v.float() for k, v in vit_state.items()})
        self.head = GFNet(cfg)
        self.head.load_state_dict({k: v.float() for k, v in head_state.items()})
        self.vit = self.vit.to(self.device).eval().requires_grad_(False)
        self.head = self.head.to(self.device).eval().requires_grad_(False)

    def _prep(self, img: Tensor, size, mode: str) -> Tensor:
        x = interpolate(img, size, mode, False, antialias=True)
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        return (x - mean) / std

    def _forward(self, a: Tensor, b: Tensor, **kw) -> dict:
        return self.head(a, b, self.vit(torch.cat([a, b])), symmetric=self.cfg.symmetric, **kw)

    @torch.no_grad()
    @numerics.exact()
    def match(self, im_a: Tensor, im_b: Tensor) -> tuple[Tensor, Tensor]:
        """(B, H, W, 3) float images in [0, 1] → warp (B, G, 2G, 4) and
        certainty (B, G, 2G), as the program's pass 1, pass 2 and stitch."""
        cfg = self.cfg
        a, b = im_a.float().to(self.device), im_b.float().to(self.device)
        num_itr = cfg.matcher.num_itr
        grids = upsample_grid_schedule(cfg.upsample_res, cfg.dino.patch_size)
        c = self._forward(self._prep(a, cfg.initial_res, "bicubic"), self._prep(b, cfg.initial_res, "bicubic"))
        low = interpolate(c["16"][num_itr[0]]["certainty"], (grids[-1], grids[-1]), "bilinear", False)
        low_res_certainty = 0.5 * low * (low < 0) if cfg.attenuate_cert else torch.zeros_like(low)
        pre = c["1"][num_itr[-1]]
        (hs, ws), (hr, wr) = cfg.upsample_res, cfg.initial_res
        c = self._forward(self._prep(a, (hs, ws), "bilinear"), self._prep(b, (hs, ws), "bilinear"),
                          upsample=True, scale_factor=math.sqrt(hs * ws / (hr * wr)),
                          pre_flow=pre["flow"], pre_certainty=pre["certainty"], num_grid=grids)
        last = c["1"][max(c["1"])]
        flow, certainty = last["flow"], last["certainty"]
        g = flow.shape[1]
        certainty = torch.sigmoid(certainty - low_res_certainty)[..., 0]
        grid = normalized_grid(g, g, device=flow.device)[None].expand(flow.shape[0], -1, -1, -1)
        certainty = torch.where((flow.abs() > 1).any(-1), torch.zeros_like(certainty), certainty)
        flow = flow.clamp(-1, 1)
        n = flow.shape[0] // 2
        q_warp = torch.cat([grid[:n], flow[:n]], dim=-1)
        s_warp = torch.cat([flow[n:], grid[:n]], dim=-1)
        return torch.cat([q_warp, s_warp], dim=2), torch.cat([certainty[:n], certainty[n:]], dim=2)

    def _sizes(self, n: int, num: int) -> tuple[int, int]:
        n_good = min(4 * num, n)
        return n_good, min(num, n_good)

    def draws(self, pair_keys, n: int, num: int):
        """Each pair's draws from its key: `k1, k2 = split(key)`; under
        `split(k1)` the certainty draw (n,) and the balanced draw (n_good,),
        uniforms on [1e-20, 1); under k2, `randint(k2, (512, 4), 0, n_out)`."""
        n_good, n_out = self._sizes(n, num)
        m = 4 * NUM_HYPOTHESES
        k1, k2 = zip(*(K.split(np.asarray(k, np.uint32)) for k in pair_keys))
        good, bal = zip(*(K.split(k) for k in k1))
        hi, lo = zip(*(K.split(k) for k in k2))
        b = len(good)
        words = K.draw_words(list(good) + list(bal) + list(hi) + list(lo),
                             [n] * b + [n_good] * b + [m] * (2 * b), self.device)
        u_good = K.uniform_of(words[:b * n].view(b, n), GUMBEL_MIN, 1.0)
        u_bal = K.uniform_of(words[b * n:b * (n + n_good)].view(b, n_good), GUMBEL_MIN, 1.0)
        hi_w, lo_w = words[-2 * b * m:].view(2, b, m)
        return u_good, u_bal, K.randint_of(hi_w, lo_w, 0, n_out).view(b, NUM_HYPOTHESES, 4)

    def _sample(self, matches: Tensor, certainty: Tensor, num: int, u_good: Tensor, u_bal: Tensor):
        cfg = self.cfg
        if "threshold" in cfg.sample_mode:
            certainty = torch.where(certainty > cfg.sample_thresh, torch.ones_like(certainty), certainty)
        n_good, n_bal = self._sizes(certainty.shape[-1], num)

        def gumbel_topk(weights, u, k):
            logw = torch.log(weights.clamp_min(1e-30))
            logw = torch.where(weights <= 0, torch.full_like(logw, -math.inf), logw)
            return topk_indices(logw - torch.log(-torch.log(u)), k)

        def take(m, c, idx):
            return torch.take_along_dim(m, idx[..., None], dim=-2), torch.take_along_dim(c, idx, dim=-1)

        good_matches, good_cert = take(matches, certainty, gumbel_topk(certainty, u_good, n_good))
        density = kde(good_matches, std=0.1)
        p = 1.0 / (density + 1.0)
        p = torch.where(density < 10, torch.full_like(p, 1e-7), p)
        return take(good_matches, good_cert, gumbel_topk(p, u_bal, n_bal))[0]

    @torch.no_grad()
    @numerics.exact()
    def sample_solve(self, warp: Tensor, certainty: Tensor, num: int, hw_a, hw_b, pair_keys) -> Tensor:
        """`num` matches a pair drawn from its warp and certainty under its
        key, and its homography (B, 3, 3) from A's pixels to B's."""
        if "balanced" not in self.cfg.sample_mode:
            raise ValueError("the reference samples threshold_balanced only")
        b = warp.shape[0]
        warp, certainty = warp.float().to(self.device), certainty.float().to(self.device)
        u_good, u_bal, idx = self.draws(pair_keys, certainty[0].numel(), num)
        matches = self._sample(warp.reshape(b, -1, 4), certainty.reshape(b, -1), num, u_good, u_bal)
        pos_a = denormalize_corner_aligned(matches[..., :2], *hw_a)
        pos_b = denormalize_corner_aligned(matches[..., 2:], *hw_b)
        return ransac_homography_from_indices(pos_a, pos_b, None, idx)[0]
