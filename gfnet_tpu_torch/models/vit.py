"""DINOv2 Vision Transformer backbone, frozen feature extractor.

Counterpart of `gfnet_tpu/models/vit.py` (ref `model/transformer/dinov2.py`):
patch embed, cls token, the bicubic pos-embed resample with its +0.1 scale
quirk, `depth` pre-norm blocks with LayerScale, the final LayerNorm, and the
patch tokens without cls (`x_norm_patchtokens`). Every attention goes
through `fused_attention` (kernel K1 on CUDA). Module names follow the
torch DINOv2 state dict, so `gfnet_tpu.utils.convert.convert_dinov2_state_dict`
reads this module's `state_dict()` as it is.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gfnet_tpu_torch.config import DinoConfig
from gfnet_tpu_torch.models.common import Conv, Dense, LayerNorm, LayerScale, gelu
from gfnet_tpu_torch.ops.attention import fused_attention
from gfnet_tpu_torch.ops.resize import interpolate

Tensor = torch.Tensor


class Attention(nn.Module):
    """Fused-QKV self attention (ref `layers/attention.py:51-101`)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        # strided views of the fused projection; K1 reads them in place
        out = fused_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(out.reshape(b, n, c))


class Mlp(nn.Module):
    """GELU MLP (ref `layers/mlp.py:17-42`)."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(gelu(self.fc1(x)))


class SwiGLUFFNFused(nn.Module):
    """SwiGLU FFN with the DINOv2 fused-width rule
    hidden = (int(hidden * 2/3) + 7) // 8 * 8 (ref `layers/swiglu_ffn.py:13-62`)."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.hf = (int(hidden * 2 / 3) + 7) // 8 * 8
        self.w12 = Dense(dim, 2 * self.hf, dtype=dtype)
        self.w3 = Dense(self.hf, dim, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        x12 = self.w12(x)
        return self.w3(torch.nn.functional.silu(x12[..., : self.hf]) * x12[..., self.hf:])


class Block(nn.Module):
    """Pre-norm residual block with LayerScale (ref `layers/block.py:36-107`)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, init_values: float,
                 ffn_layer: str, dtype: torch.dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(dim, num_heads, dtype)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        hidden = int(dim * mlp_ratio)
        if ffn_layer == "mlp":
            self.mlp = Mlp(dim, hidden, dtype)
        elif ffn_layer in ("swiglu", "swiglufused"):
            self.mlp = SwiGLUFFNFused(dim, hidden, dtype)
        else:
            raise ValueError(f"unknown ffn_layer {ffn_layer!r}")
        self.ls2 = LayerScale(dim, init_values)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


def interpolate_pos_encoding(pos: Tensor, gh: int, gw: int, base: int) -> Tensor:
    """Bicubic-resample the patch pos-embed grid with torch's explicit
    scale-factor mapping and the +0.1 anti-rounding offset
    (ref `dinov2.py:166-190`). pos: (1, base*base+1, D)."""
    if gh * gw == base * base and gh == gw:
        return pos
    d = pos.shape[-1]
    grid = pos[:, 1:].reshape(1, base, base, d)
    scale = ((gh + 0.1) / base, (gw + 0.1) / base)
    out = interpolate(grid, (gh, gw), mode="bicubic", align_corners=False, scale=scale)
    return torch.cat([pos[:, :1], out.reshape(1, gh * gw, d)], dim=1)


class VisionTransformer(nn.Module):
    """DINOv2-style ViT: NHWC images (B, H, W, 3), H and W multiples of the
    patch size → final-LN patch tokens (B, H/p * W/p, D)."""

    def __init__(self, cfg: DinoConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.d_model, cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv(3, d, p, stride=p, padding=0, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.pos_embed_size**2 + 1, d))
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.init_values, cfg.ffn_layer, dtype)
            for _ in range(cfg.depth)
        )
        self.norm = LayerNorm(d, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        cfg, dt = self.cfg, self.compute_dtype
        b, h, w, _ = x.shape
        p = cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} is not a multiple of the patch size {p}")
        gh, gw = h // p, w // p
        tok = self.patch_embed.proj(x).reshape(b, gh * gw, cfg.d_model)
        tok = torch.cat([self.cls_token.to(dt).expand(b, 1, -1), tok], dim=1)
        tok = tok + interpolate_pos_encoding(self.pos_embed, gh, gw, cfg.pos_embed_size).to(dt)
        for blk in self.blocks:
            tok = blk(tok)
        return self.norm(tok)[:, 1:]
