"""The ViT block's residual stream: LayerScale, residual add and LayerNorm.

Counterpart of the norms, LayerScale and adds of `gfnet_tpu/models/vit.py`
(`Block.__call__`, the final norm), which the JAX package leaves to XLA.
CUDA tensors go to K5, `ops/kernels.residual_norm`, one launch for what the
plain path does in up to seven; CPU tensors take `residual_norm_plain`,
the composition `models/common.LayerScale` and `LayerNorm` make. Both round
s alike; n differs only in the order of the norm's float32 sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gfnet_tpu_torch.ops import kernels

Tensor = torch.Tensor


def residual_norm(x: Tensor, h: Tensor | None = None, gamma: Tensor | None = None, weight: Tensor | None = None,
                  bias: Tensor | None = None, eps: float = 1e-6) -> tuple[Tensor, Tensor | None]:
    """(s, n): s = x + h·gamma (x where h is None), n = LayerNorm(s) with
    float32 statistics by weight and bias, in x's dtype (None where weight is
    None). On the card one K5 launch; on the CPU `residual_norm_plain`."""
    if not x.is_cuda:
        return residual_norm_plain(x, h, gamma, weight, bias, eps)
    return kernels.residual_norm(x, h, gamma, weight, bias, eps)


def residual_norm_plain(x: Tensor, h: Tensor | None = None, gamma: Tensor | None = None,
                        weight: Tensor | None = None, bias: Tensor | None = None,
                        eps: float = 1e-6) -> tuple[Tensor, Tensor | None]:
    """`residual_norm` in PyTorch ops: LayerScale's product in h's dtype, the
    add in x's, the norm in float32 and cast back to x's dtype."""
    s = x if h is None else x + h * gamma.to(h.dtype)
    if weight is None:
        return s, None
    n = F.layer_norm(s.float(), s.shape[-1:], weight.float(), bias.float(), eps)
    return s, n.to(x.dtype)
