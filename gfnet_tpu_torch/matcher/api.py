"""GFNetMatcher: the user-facing dense matching + homography API.

Counterpart of `gfnet_tpu/matcher/api.py:37-496` (ref `model/network.py:285-414`,
`estimation.py:46-92`), run eagerly under `torch.inference_mode()`:
  - pass 1 at `initial_res`: resize + normalize, the frozen ViT in the
    model dtype, the symmetric head forward, certainty-attenuation prep;
  - pass 2 at `upsample_res`: re-entry at scale "8", then the warp stitch;
  - threshold-balanced sampling: Gumbel top-k (exact, in JAX's order) + KDE;
  - batched RANSAC + IRLS on the device.
Sampling and solving take all pairs of a batch at once, as the JAX
package's vmapped `_sample_solve_batched_jit` does.

Randomness takes the JAX package's keys: a key is a (2,) uint32 array
(`utils.jax_init.prng_key(seed)`, or a JAX key as numpy), None meaning
`PRNGKey(0)`. A batch of B pairs splits its key into B pair keys, and each
pair draws from its own as JAX's batched path does: `k1, k2 = split(pair
key)`, the two Gumbel draws from `split(k1)`, the RANSAC indices from
`randint(k2, ...)`. The draws run on the matcher's device
(`utils/jax_random.py`). `_sample_core`, `_solve` and `_sample_solve` take
the draws as tensors, so tests can feed any.

With `shard_for_mesh(mesh)` the matcher serves over a process group
(`parallel/`): every rank runs the same call on the whole request. A batch
of at least as many pairs as ranks is padded by repeating its last pair and
split by rows; each rank matches, samples and solves its rows with their
pair keys, and the homographies are gathered. A smaller batch runs on every
rank, with only the coarse correlation split over the ranks. With
`fsdp_vit=True` each rank also keeps only its slice of the ViT's large
leaves.

Each layer call is a span of `utils/profiling.py` (recorded while the
recorder is on or a profiler records): `call` (`estimate_homography_batched`,
`match`, `sample`), `prep`, `pass1`, `vit`, `head`, `pass2`, `stitch`,
`draws`, `sample` (`_sample_core`) and `solve`; the head's own are in
`models/gfnet.py`.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from gfnet_tpu_torch.config import ModelConfig
from gfnet_tpu_torch.core.geometry import denormalize_corner_aligned, normalized_grid
from gfnet_tpu_torch.core.homography import ransac_homography_from_indices
from gfnet_tpu_torch.models.gfnet import GFNet
from gfnet_tpu_torch.models.vit import VisionTransformer
from gfnet_tpu_torch.ops.kde import kde
from gfnet_tpu_torch.ops.resize import interpolate
from gfnet_tpu_torch.parallel.mesh import shard_params
from gfnet_tpu_torch.utils import jax_init, jax_random
from gfnet_tpu_torch.utils.convert import jax_head_state, jax_vit_state
from gfnet_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NUM_HYPOTHESES = 512
GUMBEL_MIN = 1e-20  # the uniforms' minval in the JAX package's Gumbel draws


def as_key(key) -> "np.ndarray":
    """A JAX key as a (2,) uint32 numpy array; None is `PRNGKey(0)`."""
    return jax_init.prng_key(0) if key is None else np.asarray(key, np.uint32).reshape(2)


def topk_indices(x: Tensor, k: int) -> Tensor:
    """The indices of the k largest entries of float32 `x` along the last
    axis, largest first and ties to the lower index, as `jax.lax.top_k`
    returns them (and the CPU's `approx_max_k` for k < N): the sampler's
    later draws address positions in this order. `torch.topk` does not
    promise how it breaks ties, so it ranks one int64 key an entry: the
    float's bits made monotonic (negative values' magnitude bits flipped) in
    the high word, N - 1 - index in the low word. The keys are distinct, and
    their order is JAX's."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64)
    monotonic = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    n = x.shape[-1]
    rank = torch.arange(n - 1, -1, -1, device=x.device)
    return torch.topk(monotonic * (1 << 32) + rank, k, dim=-1).indices


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
    `utils.convert`). Either one left out is the one the JAX package's
    `GFNetMatcher(cfg, seed=seed)` draws, repeated in numpy by
    `utils/jax_init.jax_vit_params` / `jax_head_params` (its bits; normals
    within a few units in the last place). The ViT is stored in `dtype`; the
    head keeps float32 parameters and computes in `dtype`, as the JAX package
    does.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", dtype: torch.dtype = torch.bfloat16,
                 vit_state: dict | None = None, head_state: dict | None = None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        vit = VisionTransformer(cfg.dino, dtype=dtype)
        vit.load_state_dict(vit_state if vit_state is not None else jax_vit_state(cfg, seed))
        head = GFNet(cfg, dtype=dtype)
        head.load_state_dict(head_state if head_state is not None else jax_head_state(cfg, seed))
        self.mesh = None  # set by shard_for_mesh
        self.vit = vit.to(device=self.device, dtype=dtype).eval().requires_grad_(False)
        self.head = head.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_pretrained(cls, conf_path: str | None = None, ckpt_path: str | None = None,
                        dinov2_weights: str | None = None, **kw) -> "GFNetMatcher":
        """A matcher from a reference-format config JSON, a head checkpoint
        (`.npz` in the JAX package's flat `params/...`, `batch_stats/...`
        layout, a reference torch `.pth`, or an Orbax directory of
        {params, batch_stats}; `utils.convert.load_head`) and, where the
        file exists, DINOv2 weights (`.npz` as `tools/convert_dinov2.py`
        writes it, or the public `.pth`). The config's k/v standardization
        stays on; a head whose file says it was trained with it switches it on."""
        from gfnet_tpu_torch.utils.convert import load_head, load_vit

        cfg = ModelConfig.from_json(conf_path) if conf_path else ModelConfig()
        if ckpt_path:
            kw["head_state"], kv_norm = load_head(ckpt_path)
            cfg = cfg.with_head_kv_norm(kv_norm)
        if dinov2_weights and os.path.exists(dinov2_weights):
            kw["vit_state"] = load_vit(dinov2_weights)
        return cls(cfg, **kw)

    # --------------------------------------------------------------- forward
    @span("vit")
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
                pre_certainty: Tensor | None = None, corr_mesh=None) -> dict:
        """Frozen ViT + head on preprocessed NHWC images."""
        tokens = self._vit_tokens(torch.cat([im_A, im_B], dim=0))
        grids = (upsample_grid_schedule(self.cfg.upsample_res, self.cfg.dino.patch_size)
                 if upsample else None)
        with span("head"):
            return self.head(im_A, im_B, tokens, symmetric=symmetric, upsample=upsample,
                             scale_factor=scale_factor, pre_flow=pre_flow,
                             pre_certainty=pre_certainty, num_grid_override=grids,
                             corr_mesh=corr_mesh)

    @span("prep")
    def _prep_image(self, img: Tensor, size, mode: str = "bicubic") -> Tensor:
        """Antialiased resize + imagenet normalize, the reference eval
        transform: bicubic in pass 1, bilinear in pass 2, no clipping."""
        return imagenet_normalize(interpolate(img, size, mode, False, antialias=True))

    @span("pass1")
    def _pass1(self, im_A_raw: Tensor, im_B_raw: Tensor, corr_mesh=None):
        """Initial-resolution pass (ref `network.py:285-338`); `corr_mesh`
        splits the coarse correlation over its ranks (latency mode)."""
        cfg = self.cfg
        im0 = self._prep_image(im_A_raw, cfg.initial_res)
        im1 = self._prep_image(im_B_raw, cfg.initial_res)
        corresps = self.forward(im0, im1, symmetric=cfg.symmetric, corr_mesh=corr_mesh)
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

    @span("pass2")
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
        with span("stitch"):
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

    def _match_batch(self, a: Tensor, b: Tensor, corr_mesh=None) -> tuple[Tensor, Tensor]:
        pre_flow, pre_cert, low = self._pass1(a, b, corr_mesh)
        return self._pass2(a, b, pre_flow, pre_cert, low)

    @span("call")
    @torch.inference_mode()
    def match(self, im_A_raw, im_B_raw) -> tuple[Tensor, Tensor]:
        """im_*_raw: (H, W, 3) or (B, H, W, 3) float in [0, 1] → the dense warp
        (B, G, 2G, 4) and certainty (B, G, 2G) (no batch axis for 3-D input).
        Under a mesh every rank returns the whole batch."""
        batched = torch.as_tensor(im_A_raw).dim() == 4
        a, b = self._as_batch(im_A_raw), self._as_batch(im_B_raw)
        (a, b), corr_mesh, gather = self._place_batch(a.shape[0], a, b)
        warp, certainty = (gather(t) for t in self._match_batch(a, b, corr_mesh))
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

    @span("sample")
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
            return topk_indices(logw - torch.log(-torch.log(u)), k)

        def take(m, c, idx):
            return torch.take_along_dim(m, idx[..., None], dim=-2), torch.take_along_dim(c, idx, dim=-1)

        good_matches, good_cert = take(matches, certainty, gumbel_topk(certainty, u_good, n_good))
        if "balanced" not in cfg.sample_mode:
            return good_matches, good_cert
        density = kde(good_matches, std=0.1)
        p = 1.0 / (density + 1.0)
        p = torch.where(density < 10, torch.full_like(p, 1e-7), p)
        return take(good_matches, good_cert, gumbel_topk(p, u_bal, n_bal))

    def _draws(self, sample_keys, ransac_keys, n: int, num: int):
        """The random numbers the JAX package draws for sampling and solving:
        under each sample key, the certainty draw (N,) and the balanced draw
        (n_good,), uniforms on [1e-20, 1) under the two keys of its split;
        under each RANSAC key, `randint(key, (K, 4), 0, n_out)`. All words
        are hashed in one pass on the device. Returns u_good (B, N), u_bal
        (B, n_good) or None, and idx (B, K, 4) or None without RANSAC keys."""
        n_good, n_out = self._sample_sizes(n, num)
        balanced = "balanced" in self.cfg.sample_mode
        m = 4 * NUM_HYPOTHESES

        def halves(keys):
            pairs = [jax_init.split(as_key(k)) for k in keys]
            return [p[0] for p in pairs], [p[1] for p in pairs]

        good, bal = halves(sample_keys)
        bal = bal if balanced else []
        hi, lo = halves(ransac_keys)
        b, r = len(good), len(hi)
        words = jax_random.draw_words(good + bal + hi + lo,
                                      [n] * b + [n_good] * len(bal) + [m] * (2 * r), self.device)
        u_good = jax_random.uniform_of(words[:b * n].view(b, n), GUMBEL_MIN, 1.0)
        u_bal = (jax_random.uniform_of(words[b * n:b * (n + n_good)].view(b, n_good), GUMBEL_MIN, 1.0)
                 if balanced else None)
        if not r:
            return u_good, u_bal, None
        hi_w, lo_w = words[-2 * r * m:].view(2, r, m)
        return u_good, u_bal, jax_random.randint_of(hi_w, lo_w, 0, n_out).view(r, NUM_HYPOTHESES, 4)

    @span("draws")
    def _pair_draws(self, pair_keys, n: int, num: int) -> tuple[Tensor, Tensor | None, Tensor]:
        """Each pair's draws from its key, as the JAX package's
        `_sample_solve_batched_jit` makes them: `k1, k2 = split(key)`,
        sampling under k1 and RANSAC under k2 (`_draws`)."""
        k1, k2 = zip(*(jax_init.split(as_key(k)) for k in pair_keys))
        return self._draws(k1, k2, n, num)

    @span("call")
    @torch.inference_mode()
    def sample(self, matches, certainty, num: int = 5000, key=None) -> tuple[Tensor, Tensor]:
        """`num` matches drawn from a pair's warp and certainty, with the
        JAX package's `sample(..., key)` draws: the two Gumbel draws from
        `split(key)`."""
        m = torch.as_tensor(matches).to(self.device).reshape(-1, 4)
        c = torch.as_tensor(certainty).to(self.device).reshape(-1)
        u_good, u_bal, _ = self._draws([key], [], c.shape[0], num)
        return self._sample_core(m, c, num, u_good[0], None if u_bal is None else u_bal[0])

    # ----------------------------------------------------------------- solve
    @span("solve")
    def _solve(self, matches: Tensor, hw_a: tuple[int, int], hw_b: tuple[int, int],
               idx: Tensor) -> Tensor:
        """Denormalize sampled matches (..., N, 4) to pixels and solve with
        the given (..., K, 4) RANSAC indices → H (..., 3, 3) mapping A pixels
        to B pixels."""
        pos_a = denormalize_corner_aligned(matches[..., :2], *hw_a)
        pos_b = denormalize_corner_aligned(matches[..., 2:], *hw_b)
        return ransac_homography_from_indices(pos_a, pos_b, None, idx)[0]

    def _sample_solve(self, warp: Tensor, certainty: Tensor, num: int, hw_a, hw_b,
                      draws: tuple) -> Tensor:
        """Sample `num` matches per pair and solve, all B pairs at once, with
        the pairs' draws given (`_pair_draws`) → (B, 3, 3)."""
        b = warp.shape[0]
        u_good, u_bal, idx = draws
        matches, _ = self._sample_core(warp.reshape(b, -1, 4), certainty.reshape(b, -1), num,
                                       u_good, u_bal)
        return self._solve(matches, hw_a, hw_b, idx)

    # ------------------------------------------------------ several devices
    def shard_for_mesh(self, mesh, fsdp_vit: bool = False) -> None:
        """Serve over `mesh` (`parallel.mesh.create_mesh`): every rank then
        calls `match` / `estimate_homography*` with the same request (the
        JAX package's `shard_for_mesh`, with processes for devices).
        `fsdp_vit` shards the frozen ViT over the ranks, in place
        (`parallel.mesh.shard_params`): each block all-gathers its weights
        when it runs."""
        self.mesh = mesh
        if fsdp_vit:
            shard_params(mesh, self.vit)

    def _place_batch(self, n: int, *xs):
        """How a batch of `n` runs: (the inputs `xs` as this rank runs them,
        the mesh its coarse correlation is split over, `gather`, which makes
        the batch's results from this rank's). Without a mesh the batch runs
        whole. A batch at least as large as the mesh has its last row
        repeated until it splits evenly over the ranks (the JAX package's
        `_pad_to_mesh`), each rank runs its rows, and `gather` stacks every
        rank's results back to `n` rows. A smaller batch runs whole on every
        rank with only its coarse correlation split (latency mode)."""
        if self.mesh is None or n < self.mesh.size:
            return xs, self.mesh, lambda t: t
        pad = (-n) % self.mesh.size

        def rows(x):
            if pad:
                x = (torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if torch.is_tensor(x)
                     else np.concatenate([x, x[-1:].repeat(pad, 0)]))
            return x[self.mesh.rows(len(x))]

        return tuple(rows(x) for x in xs), None, lambda t: self.mesh.all_gather_rows(t)[:n]

    @span("call")
    @torch.inference_mode()
    def estimate_homography_batched(self, im_A_raw, im_B_raw, num_matches: int = 5000,
                                    key=None, pair_keys=None) -> Tensor:
        """match → sample → robust solve for (B, H, W, 3) pairs → (B, 3, 3),
        H mapping image-A pixels to image-B pixels at the input resolutions
        (corner-aligned, ref `estimation.py:26-45`). Pair i draws from
        `split(key, B)[i]`, as in the JAX package, or from `pair_keys[i]`
        where they are given (a benchmark that repeats JAX's serial chain
        hands each pair its own)."""
        a, b = self._as_batch(im_A_raw), self._as_batch(im_B_raw)
        n_pairs, hw_a, hw_b = a.shape[0], tuple(a.shape[1:3]), tuple(b.shape[1:3])
        keys = (jax_init.split(as_key(key), n_pairs) if pair_keys is None
                else np.asarray(pair_keys, np.uint32).reshape(n_pairs, 2))
        (a, b, keys), corr_mesh, gather = self._place_batch(n_pairs, a, b, keys)
        warp, certainty = self._match_batch(a, b, corr_mesh)
        draws = self._pair_draws(keys, certainty[0].numel(), num_matches)
        return gather(self._sample_solve(warp, certainty, num_matches, hw_a, hw_b, draws))

    def estimate_homography(self, im_A_raw, im_B_raw, num_matches: int = 5000, key=None) -> Tensor:
        """One (H, W, 3) pair → H (3, 3), drawn from `split(key, 1)[0]` as
        the JAX package's `estimate_homography` draws (the first pair's key
        of a batch under the same key)."""
        return self.estimate_homography_batched(im_A_raw, im_B_raw, num_matches, key)[0]
