"""GFNet head: cross-view decoding, FPN fusion, coarse-to-fine refinement.

Counterpart of `gfnet_tpu/models/gfnet.py:45-264` (ref
`model/network.py:17-283`):
  - the two views stacked to 2B through shared extractors, and the
    symmetric duplication with swapped roles;
  - the coarse init: global correlation + softmax expectation at the ViT
    grid, split over the ranks of `corr_mesh` where the JAX package splits
    it (`_use_sharded_corr`);
  - per-scale ConvRefiners with displacement scaling `int(scale)/(4*W0)`;
  - the inference early-zero of converged displacements (rel < 1e-6);
  - detached bilinear upsampling between scales;
  - the upsample pass re-entering at scale "8" from a previous flow.
In train mode (`nn.Module.train()`), as the JAX forward under `train=True`:
BatchNorms use batch statistics, converged displacements are not zeroed, and
the feature extraction and each refiner call are recomputed in backward
instead of keeping their activations (`gfnet_tpu/models/gfnet.py:172-183,
228-250`).
The frozen ViT is not a submodule: the head takes its patch tokens. Module
names follow the reference state dict (`dino_decoder`, `encoder`,
`decoder`, `merge_layer`, `conv_refiner.{scale}`).
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn

from gfnet_tpu_torch.config import ModelConfig
from gfnet_tpu_torch.models.common import checkpoint_module
from gfnet_tpu_torch.models.crossview import CrossViewDecoder
from gfnet_tpu_torch.models.fpn import FPNDecoder, FPNEncoder, conv_bn_act
from gfnet_tpu_torch.models.refiner import ConvRefiner
from gfnet_tpu_torch.ops.correlation import corr_volume_flow, corr_volume_flow_sharded
from gfnet_tpu_torch.ops.resize import interpolate

Tensor = torch.Tensor

SCALES = ("16", "8", "4", "2", "1")


class GFNet(nn.Module):
    """Matching head: everything except the frozen ViT."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        fd = tuple(cfg.encoder.feat_chs)  # coarse→fine (64, 32, 16, 8)
        self.dino_decoder = CrossViewDecoder(cfg.dino.d_model, fd[0], cfg.dino.decoder_cfg, dtype)
        self.encoder = FPNEncoder(fd[::-1], dtype)
        self.decoder = FPNDecoder(fd[::-1], dtype)
        self.merge_layer = conv_bn_act(2 * fd[0], fd[0], 3, act="swish", conv_bias=True, dtype=dtype)
        feat_at_scale = {"16": fd[0], "8": fd[0], "4": fd[1], "2": fd[2], "1": fd[3]}
        refiners = {}
        for i, scale in enumerate(SCALES):
            r = cfg.matcher.radius[i]
            k = (2 * r + 1) ** 2 if r > 0 else 0
            disp = cfg.matcher.displacement_dim[i]
            refiners[scale] = ConvRefiner(2 * feat_at_scale[scale] + disp + k, disp, r, dtype=dtype)
        self.conv_refiner = nn.ModuleDict(refiners)

    @staticmethod
    def _use_sharded_corr(corr_mesh, f_shape) -> bool:
        """The JAX package's routing (`gfnet_tpu/models/gfnet.py:106-115`):
        the grid-split correlation where the batch B' leaves the mesh idle
        (B' % d != 0) and the target cells split evenly."""
        if corr_mesh is None:
            return False
        d = corr_mesh.size
        return f_shape[0] % d != 0 and (f_shape[1] * f_shape[2]) % d == 0

    def extract_features(self, x: Tensor, vit_tokens: Tensor, grid_hw: tuple[int, int],
                         upsample: bool = False) -> tuple[dict, dict]:
        """Per-view 5-level pyramids (ref `network.py:156-201`). x: (2B, H, W, 3)
        stacked [view A; view B]; vit_tokens (2B, gh*gw, d_vit)."""
        twob, h, w, _ = x.shape
        b = twob // 2
        vit0, vit1 = self.dino_decoder(vit_tokens[:b], vit_tokens[b:], grid_hw)
        vit_feat = torch.cat([vit0, vit1], dim=0).float()
        vit_up = interpolate(vit_feat, (h // 8, w // 8), "bilinear", False)
        conv01, conv11, conv21, conv31 = self.encoder(x)
        merged = self.merge_layer(torch.cat([conv31, vit_up.to(conv31.dtype)], dim=-1))
        feats = self.decoder(conv01, conv11, conv21, conv31 + merged)
        pyr = dict(zip(SCALES, [vit_feat, *feats]))
        if upsample:
            del pyr["16"]
        return {s: t[:b] for s, t in pyr.items()}, {s: t[b:] for s, t in pyr.items()}

    def forward(self, im_A: Tensor, im_B: Tensor, vit_tokens: Tensor, symmetric: bool = False,
                upsample: bool = False, scale_factor: float = 1.0,
                pre_flow: Tensor | None = None, pre_certainty: Tensor | None = None,
                num_grid_override: tuple[int, ...] | None = None, corr_mesh=None) -> dict:
        """Coarse-to-fine forward (ref `network.py:203-283`). Returns
        corresps[scale][itr] = {"flow": (B', G, G, 2), "certainty": (B', G, G, 1)},
        B' = 2B when symmetric. `corr_mesh`: a mesh whose every rank holds
        this same batch (the matcher's latency mode)."""
        cfg = self.cfg
        _, h0, w0, _ = im_A.shape
        x = torch.cat([im_A, im_B], dim=0)
        gh, gw = h0 // cfg.dino.patch_size, w0 // cfg.dino.patch_size
        if self.training:
            f0s, f1s = checkpoint_module(
                self, partial(self.extract_features, grid_hw=(gh, gw), upsample=upsample),
                x, vit_tokens)
        else:
            f0s, f1s = self.extract_features(x, vit_tokens, (gh, gw), upsample=upsample)
        scales = [s for s in SCALES if s in f0s]
        if symmetric:
            f0s, f1s = ({s: torch.cat([f0s[s], f1s[s]]) for s in scales},
                        {s: torch.cat([f1s[s], f0s[s]]) for s in scales})
        if upsample:
            num_grid = num_grid_override
            num_itr = cfg.matcher.num_itr[-len(scales):]
            if pre_flow is None or pre_certainty is None:
                raise ValueError("the upsample pass needs pre_flow and pre_certainty")
        else:
            num_grid = cfg.matcher.num_grid
            num_itr = cfg.matcher.num_itr
        if num_grid is None or len(num_grid) != len(scales):
            raise ValueError(f"num_grid {num_grid} does not cover scales {scales}")

        corresps: dict = {}
        flow = certainty = None
        for idx, scale in enumerate(scales):
            f0, f1 = f0s[scale], f1s[scale]
            g = num_grid[idx]
            if idx == 0:
                if upsample:
                    flow = interpolate(pre_flow, (g, g), "bilinear", False)
                    certainty = interpolate(pre_certainty, (g, g), "bilinear", False)
                else:
                    flow = (corr_volume_flow_sharded(f0, f1, corr_mesh)
                            if self._use_sharded_corr(corr_mesh, f0.shape) else corr_volume_flow(f0, f1))
                    certainty = torch.zeros(flow.shape[:-1] + (1,), dtype=flow.dtype, device=flow.device)
            corresps[scale] = {}
            displacement_pre = torch.zeros_like(flow) + 1e-7
            for itr in range(num_itr[idx]):
                refiner = self.conv_refiner[scale]
                if self.training:
                    delta_flow, delta_cert = checkpoint_module(
                        refiner, partial(refiner, scale_factor=scale_factor), f0, f1, flow)
                else:
                    delta_flow, delta_cert = refiner(f0, f1, flow, scale_factor=scale_factor)
                displacement = float(int(scale)) * torch.stack(
                    [delta_flow[..., 0] / (4 * w0), delta_flow[..., 1] / (4 * h0)], dim=-1)
                if not self.training:
                    rel = (displacement - displacement_pre).abs() / displacement_pre.abs()
                    displacement = torch.where(rel < 1e-6, torch.zeros_like(displacement), displacement)
                flow = flow + displacement
                certainty = certainty + delta_cert
                corresps[scale][itr + 1] = {"flow": flow, "certainty": certainty}
                displacement_pre = displacement
            if scale != "1":
                g_next = num_grid[idx + 1]
                flow = interpolate(flow, (g_next, g_next), "bilinear", False).detach()
                certainty = interpolate(certainty, (g_next, g_next), "bilinear", False).detach()
        return corresps
