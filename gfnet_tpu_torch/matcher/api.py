"""GFNetMatcher: the user-facing dense matching + homography API.

Counterpart of `gfnet_tpu/matcher/api.py:37-496` (ref `model/network.py:285-414`,
`estimation.py:46-92`), run eagerly under `torch.inference_mode()`:
  - pass 1 at `initial_res`: resize + normalize, the frozen ViT in the
    model dtype, the symmetric head forward, certainty-attenuation prep;
  - pass 2 at `upsample_res`: re-entry at scale "8", then the warp stitch;
  - threshold-balanced sampling: Gumbel top-k (exact `torch.topk`) + KDE;
  - batched RANSAC + IRLS on the device.
Sampling and solving take all pairs of a batch at once, as the JAX
package's vmapped `_sample_solve_batched_jit` does.

Randomness comes from an explicit `torch.Generator`. The public `sample`
and `estimate_homography*` draw the Gumbel uniforms and RANSAC indices;
`_sample_core`, `_solve` and `_sample_solve` take them, so tests can feed
the JAX draws.
Per pair the draws come in one order (uniforms, then RANSAC indices), so
`estimate_homography` equals the first pair of `estimate_homography_batched`
for the same generator state.
"""

from __future__ import annotations

import math

import torch

from gfnet_tpu_torch.config import ModelConfig
from gfnet_tpu_torch.core.geometry import denormalize_corner_aligned, normalized_grid
from gfnet_tpu_torch.core.homography import ransac_homography_from_indices
from gfnet_tpu_torch.models.common import init_params
from gfnet_tpu_torch.models.gfnet import GFNet
from gfnet_tpu_torch.models.vit import VisionTransformer
from gfnet_tpu_torch.ops.kde import kde
from gfnet_tpu_torch.ops.resize import interpolate

Tensor = torch.Tensor

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NUM_HYPOTHESES = 512


def imagenet_normalize(x: Tensor) -> Tensor:
    """(..., 3) in [0,1] → imagenet-normalized (ref `utils/utils.py:25-26`)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def upsample_grid_schedule(upsample_res: tuple[int, int], patch: int = 14) -> tuple[int, ...]:
    """num_grid of the refinement pass (ref `model/network.py:329`)."""
    g0 = int(upsample_res[0] / patch)
    return (g0, 2 * g0, 4 * g0, 8 * g0)


def resolve_device(device) -> torch.device:
    """The device to run on; asking for CUDA where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run the plain PyTorch path")
    return dev


class GFNetMatcher:
    """Inference API around the frozen ViT + GFNet head.

    Weights: `vit_state` / `head_state` are state dicts (e.g. from
    `utils.convert`); missing ones get a seeded random init. The ViT is
    stored in `dtype`; the head keeps float32 parameters and computes in
    `dtype`, as the JAX package does.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", dtype: torch.dtype = torch.bfloat16,
                 vit_state: dict | None = None, head_state: dict | None = None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        vit = VisionTransformer(cfg.dino, dtype=dtype)
        head = GFNet(cfg, dtype=dtype)
        init_params(vit, gen)
        init_params(head, gen)
        if vit_state is not None:
            vit.load_state_dict(vit_state)
        if head_state is not None:
            head.load_state_dict(head_state)
        self.vit = vit.to(device=self.device, dtype=dtype).eval().requires_grad_(False)
        self.head = head.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_pretrained(cls, conf_path: str | None = None, ckpt_path: str | None = None,
                        **kw) -> "GFNetMatcher":
        """A matcher from a reference-format config JSON and an `.npz` head
        (the flat `params/...`, `batch_stats/...` layout the JAX package
        writes). A head trained with k/v standardization switches it on."""
        from gfnet_tpu_torch.utils.convert import load_head_npz

        cfg = ModelConfig.from_json(conf_path) if conf_path else ModelConfig()
        head_state = None
        if ckpt_path:
            head_state, kv_norm = load_head_npz(ckpt_path)
            cfg = cfg.with_kv_norm(kv_norm)
        return cls(cfg, head_state=head_state, **kw)

    # --------------------------------------------------------------- forward
    def _vit_tokens(self, x: Tensor) -> Tensor:
        """Frozen backbone tokens for stacked views (2B, H, W, 3)."""
        p = self.cfg.dino.patch_size
        h, w = x.shape[1], x.shape[2]
        vh, vw = (h // p) * p, (w // p) * p
        if (vh, vw) != (h, w):  # ref `network.py:158-164`
            x = interpolate(x, (vh, vw), "bilinear", False)
        return self.vit(x)

    def forward(self, im_A: Tensor, im_B: Tensor, symmetric: bool = False, upsample: bool = False,
                scale_factor: float = 1.0, pre_flow: Tensor | None = None,
                pre_certainty: Tensor | None = None) -> dict:
        """Frozen ViT + head on preprocessed NHWC images."""
        tokens = self._vit_tokens(torch.cat([im_A, im_B], dim=0))
        grids = (upsample_grid_schedule(self.cfg.upsample_res, self.cfg.dino.patch_size)
                 if upsample else None)
        return self.head(im_A, im_B, tokens, symmetric=symmetric, upsample=upsample,
                         scale_factor=scale_factor, pre_flow=pre_flow,
                         pre_certainty=pre_certainty, num_grid_override=grids)

    def _prep_image(self, img: Tensor, size, mode: str = "bicubic") -> Tensor:
        """Antialiased resize + imagenet normalize, the reference eval
        transform: bicubic in pass 1, bilinear in pass 2, no clipping."""
        return imagenet_normalize(interpolate(img, size, mode, False, antialias=True))

    def _pass1(self, im_A_raw: Tensor, im_B_raw: Tensor):
        """Initial-resolution pass (ref `network.py:285-338`)."""
        cfg = self.cfg
        im0 = self._prep_image(im_A_raw, cfg.initial_res)
        im1 = self._prep_image(im_B_raw, cfg.initial_res)
        corresps = self.forward(im0, im1, symmetric=cfg.symmetric)
        num_itr = cfg.matcher.num_itr
        if cfg.upsample_preds:
            g_final = upsample_grid_schedule(cfg.upsample_res, cfg.dino.patch_size)[-1]
        else:
            g_final = cfg.matcher.num_grid[-1]
        low = interpolate(corresps["16"][num_itr[0]]["certainty"], (g_final, g_final),
                          "bilinear", False)
        if cfg.attenuate_cert:  # ref `network.py:332-338,360`
            low_res_certainty = 0.5 * low * (low < 0)
        else:
            low_res_certainty = torch.zeros_like(low)
        finest = corresps["1"][num_itr[-1]]
        return finest["flow"], finest["certainty"], low_res_certainty

    def _pass2(self, im_A_raw: Tensor, im_B_raw: Tensor, pre_flow: Tensor, pre_cert: Tensor,
               low_res_certainty: Tensor):
        """Upsample-refinement pass + warp stitch (ref `network.py:339-384`)."""
        cfg = self.cfg
        sym = cfg.symmetric
        if cfg.upsample_preds:
            hs, ws = cfg.upsample_res
            h_r, w_r = cfg.initial_res
            im0u = self._prep_image(im_A_raw, (hs, ws), mode="bilinear")
            im1u = self._prep_image(im_B_raw, (hs, ws), mode="bilinear")
            corresps = self.forward(im0u, im1u, symmetric=sym, upsample=True,
                                    scale_factor=math.sqrt(hs * ws / (h_r * w_r)),
                                    pre_flow=pre_flow, pre_certainty=pre_cert)
            last = corresps["1"][max(corresps["1"])]
            flow, certainty = last["flow"], last["certainty"]
        else:
            flow, certainty = pre_flow, pre_cert
        g = flow.shape[1]
        certainty = torch.sigmoid(certainty - low_res_certainty)[..., 0]
        grid = normalized_grid(g, g, device=flow.device)[None].expand(flow.shape[0], -1, -1, -1)
        wrong = (flow.abs() > 1).any(-1)
        certainty = torch.where(wrong, torch.zeros_like(certainty), certainty)
        flow = flow.clamp(-1, 1)
        if sym:
            b = flow.shape[0] // 2
            q_warp = torch.cat([grid[:b], flow[:b]], dim=-1)
            s_warp = torch.cat([flow[b:], grid[:b]], dim=-1)
            return torch.cat([q_warp, s_warp], dim=2), torch.cat([certainty[:b], certainty[b:]], dim=2)
        return torch.cat([grid, flow], dim=-1), certainty

    def _as_batch(self, im: Tensor) -> Tensor:
        im = torch.as_tensor(im, dtype=torch.float32).to(self.device)
        return im[None] if im.dim() == 3 else im

    @torch.inference_mode()
    def match(self, im_A_raw, im_B_raw) -> tuple[Tensor, Tensor]:
        """im_*_raw: (H, W, 3) or (B, H, W, 3) float in [0, 1] → the dense warp
        (B, G, 2G, 4) and certainty (B, G, 2G) (no batch axis for 3-D input)."""
        batched = torch.as_tensor(im_A_raw).dim() == 4
        a, b = self._as_batch(im_A_raw), self._as_batch(im_B_raw)
        pre_flow, pre_cert, low = self._pass1(a, b)
        warp, certainty = self._pass2(a, b, pre_flow, pre_cert, low)
        if not batched:
            return warp[0], certainty[0]
        return warp, certainty

    # ---------------------------------------------------------------- sample
    def _sample_sizes(self, n: int, num: int) -> tuple[int, int]:
        """(candidates drawn by certainty, matches returned) for N matches."""
        if "balanced" not in self.cfg.sample_mode:
            n_good = min(num, n)
            return n_good, n_good
        n_good = min(4 * num, n)
        return n_good, min(num, n_good)

    def _sample_core(self, matches: Tensor, certainty: Tensor, num: int, u_good: Tensor,
                     u_bal: Tensor | None) -> tuple[Tensor, Tensor]:
        """threshold_balanced sampling (ref `network.py:385-414`) with the
        Gumbel uniforms given: u_good (..., N) for the certainty draw, u_bal
        (..., n_good) for the KDE-balanced draw. matches (..., N, 4),
        certainty (..., N); leading dims are pairs, sampled all at once."""
        cfg = self.cfg
        if "threshold" in cfg.sample_mode:
            certainty = torch.where(certainty > cfg.sample_thresh, torch.ones_like(certainty), certainty)
        n_good, n_bal = self._sample_sizes(certainty.shape[-1], num)

        def gumbel_topk(weights, u, k):
            logw = torch.log(weights.clamp_min(1e-30))
            logw = torch.where(weights <= 0, torch.full_like(logw, -math.inf), logw)
            return torch.topk(logw - torch.log(-torch.log(u)), k).indices

        def take(m, c, idx):
            return torch.take_along_dim(m, idx[..., None], dim=-2), torch.take_along_dim(c, idx, dim=-1)

        good_matches, good_cert = take(matches, certainty, gumbel_topk(certainty, u_good, n_good))
        if "balanced" not in cfg.sample_mode:
            return good_matches, good_cert
        density = kde(good_matches, std=0.1)
        p = 1.0 / (density + 1.0)
        p = torch.where(density < 10, torch.full_like(p, 1e-7), p)
        return take(good_matches, good_cert, gumbel_topk(p, u_bal, n_bal))

    def _draws(self, n: int, num: int, generator: torch.Generator):
        """One pair's random numbers, in order: the Gumbel uniforms of the
        certainty draw (N,), of the balanced draw (n_good,) or None, and the
        (K, 4) RANSAC minimal-sample indices."""
        n_good, n_out = self._sample_sizes(n, num)
        u = lambda k: torch.rand(k, generator=generator, device=self.device).clamp_min(1e-20)
        u_good = u(n)
        u_bal = u(n_good) if "balanced" in self.cfg.sample_mode else None
        idx = torch.randint(0, n_out, (NUM_HYPOTHESES, 4), generator=generator, device=self.device)
        return u_good, u_bal, idx

    @torch.inference_mode()
    def sample(self, matches, certainty, num: int = 5000,
               generator: torch.Generator | None = None) -> tuple[Tensor, Tensor]:
        generator = generator or torch.Generator(self.device).manual_seed(0)
        m = torch.as_tensor(matches).to(self.device).reshape(-1, 4)
        c = torch.as_tensor(certainty).to(self.device).reshape(-1)
        u_good, u_bal, _ = self._draws(c.shape[0], num, generator)
        return self._sample_core(m, c, num, u_good, u_bal)

    # ----------------------------------------------------------------- solve
    def _solve(self, matches: Tensor, hw_a: tuple[int, int], hw_b: tuple[int, int],
               idx: Tensor) -> Tensor:
        """Denormalize sampled matches (..., N, 4) to pixels and solve with
        the given (..., K, 4) RANSAC indices → H (..., 3, 3) mapping A pixels
        to B pixels."""
        pos_a = denormalize_corner_aligned(matches[..., :2], *hw_a)
        pos_b = denormalize_corner_aligned(matches[..., 2:], *hw_b)
        return ransac_homography_from_indices(pos_a, pos_b, None, idx)[0]

    def _sample_solve(self, warp: Tensor, certainty: Tensor, num: int, hw_a, hw_b,
                      draws: list) -> Tensor:
        """Sample `num` matches per pair and solve, all B pairs at once, with
        each pair's `_draws` given → (B, 3, 3)."""
        b = warp.shape[0]
        u_good, u_bal, idx = (None if d[0] is None else torch.stack(d) for d in zip(*draws))
        matches, _ = self._sample_core(warp.reshape(b, -1, 4), certainty.reshape(b, -1), num,
                                       u_good, u_bal)
        return self._solve(matches, hw_a, hw_b, idx)

    @torch.inference_mode()
    def estimate_homography_batched(self, im_A_raw, im_B_raw, num_matches: int = 5000,
                                    generator: torch.Generator | None = None) -> Tensor:
        """match → sample → robust solve for (B, H, W, 3) pairs → (B, 3, 3),
        H mapping image-A pixels to image-B pixels at the input resolutions
        (corner-aligned, ref `estimation.py:26-45`)."""
        generator = generator or torch.Generator(self.device).manual_seed(0)
        a, b = self._as_batch(im_A_raw), self._as_batch(im_B_raw)
        warp, certainty = self.match(a, b)
        draws = [self._draws(certainty[0].numel(), num_matches, generator) for _ in range(len(a))]
        return self._sample_solve(warp, certainty, num_matches, tuple(a.shape[1:3]),
                                  tuple(b.shape[1:3]), draws)

    def estimate_homography(self, im_A_raw, im_B_raw, num_matches: int = 5000,
                            generator: torch.Generator | None = None) -> Tensor:
        """One (H, W, 3) pair → H (3, 3)."""
        return self.estimate_homography_batched(im_A_raw, im_B_raw, num_matches, generator)[0]
