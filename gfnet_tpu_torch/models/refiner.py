"""Per-scale ConvRefiner: flow/certainty refinement head.

Counterpart of the plain path of `gfnet_tpu/models/refiner.py:369-435`
(ref `model/network.py:444-564`):
  - warp the target features by the current flow (`grid_sample`);
  - resample the query features onto the regular G x G grid (a separable
    bilinear resize);
  - 1x1-embed the displacement `40/32 * scale_factor * (flow - grid)`;
  - local correlation through kernel K2 for radius > 0, with gradient (kernel
    K3) to the query features but not to target or flow (ref
    `disable_local_corr_grad=True`);
  - `block1` and the hidden blocks (depthwise 5x5 in float32 → BN → ReLU →
    1x1; at inference on the card the first three are one launch of kernel
    K6), then `out_conv` in float32 → (Δflow, Δcertainty).
In train mode (`nn.Module.train()`) the BatchNorms use batch statistics
(momentum 0.01, flax 0.99), the local correlation takes float32 operands and
each hidden block is recomputed in backward, as the JAX forward does under
`train=True` (`gfnet_tpu/models/refiner.py:389-396,415-420`).
The JAX package's space-to-depth stack is a TPU lowering of the same math
and has no counterpart here. Module names follow the reference state dict
(`block1.0/1/3`, `hidden_blocks.{j}`, `disp_emb`, `out_conv`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gfnet_tpu_torch.core.geometry import normalized_grid
from gfnet_tpu_torch.models.common import Act, BatchNorm, Conv, checkpoint_module
from gfnet_tpu_torch.ops import kernels
from gfnet_tpu_torch.ops.local_correlation import local_correlation
from gfnet_tpu_torch.ops.resize import interpolate
from gfnet_tpu_torch.ops.sampler import grid_sample

Tensor = torch.Tensor


class RefineBlock(nn.Sequential):
    """depthwise KxK conv → BN → ReLU → 1x1 conv (ref `network.py:505-531`),
    the modules `0`, `1`, `2`, `3`. On CUDA in eval mode the first three are
    one K6 launch (`ops/kernels.refine_block`, the plain chain's roundings in
    the block's dtype, bf16 or float32), then `3`; K6 raises on what it
    cannot take (a kernel other than 5x5, grad through it). On the CPU, and
    in training with its batch statistics, recomputation and backward, the
    four modules run in turn."""

    def __init__(self, features: int, kernel: int, dtype: torch.dtype):
        super().__init__(
            Conv(features, features, kernel, depthwise=True, dtype=dtype),
            BatchNorm(features),
            Act("relu", dtype),
            Conv(features, features, 1, dtype=dtype),
        )

    def forward(self, x: Tensor) -> Tensor:
        if not x.is_cuda or self.training:
            return super().forward(x)
        dw, bn = self[0], self[1]
        y = kernels.refine_block(x.to(dw.compute_dtype).contiguous(), dw.weight.float(), dw.bias.float(),
                                 bn.running_mean.float(), bn.running_var.float(), bn.weight.float(),
                                 bn.bias.float(), bn.eps)
        return self[3](y)


class ConvRefiner(nn.Module):
    """One coarse-to-fine refinement head (ref `network.py:444-564`)."""

    def __init__(self, hidden_dim: int, displacement_dim: int, radius: int,
                 hidden_blocks: int = 8, kernel_size: int = 5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden_dim, self.radius = hidden_dim, radius
        self.compute_dtype = dtype
        self.disp_emb = Conv(2, displacement_dim, 1, dtype=dtype)
        self.block1 = RefineBlock(hidden_dim, kernel_size, dtype)
        self.hidden_blocks = nn.Sequential(
            *(RefineBlock(hidden_dim, kernel_size, dtype) for _ in range(hidden_blocks))
        )
        self.out_conv = Conv(hidden_dim, 3, 1, dtype=torch.float32)

    def forward(self, query_feat: Tensor, target_feat: Tensor, flow: Tensor,
                scale_factor: float = 1.0) -> tuple[Tensor, Tensor]:
        """query_feat, target_feat: (B, h, w, C) NHWC; flow (B, G, G, 2)
        normalized target coords → (Δflow (B, G, G, 2), Δcert (B, G, G, 1))."""
        g = flow.shape[1]
        dt = self.compute_dtype
        target = target_feat.to(dt)
        x_hat = grid_sample(target, flow)
        grid_feature = interpolate(query_feat.to(dt), (g, g), "bilinear", False)
        grid = normalized_grid(g, g, device=flow.device)[None]
        emb = self.disp_emb((40.0 / 32.0 * scale_factor * (flow - grid)).to(dt))
        feats = [grid_feature, x_hat, emb]
        if self.radius > 0:
            # storage in the model dtype at inference (lossless: the features
            # were produced in it), float32 operands in training
            op = torch.float32 if self.training else dt
            corr = local_correlation(grid_feature.to(op), target.to(op).detach(),
                                     flow.detach(), self.radius)
            feats.append(corr.to(dt))
        d = torch.cat(feats, dim=-1)
        if d.shape[-1] != self.hidden_dim:
            raise ValueError(f"refiner input has {d.shape[-1]} channels, expected {self.hidden_dim}")
        d = self.block1(d)
        for block in self.hidden_blocks:
            d = checkpoint_module(block, block, d) if self.training else block(d)
        out = self.out_conv(d.float())
        return out[..., :2], out[..., 2:3]
