"""DINOv2's ViT with register tokens in plain PyTorch, float32, eval mode.

Follows `dinov2/models/vision_transformer.py` (`DinoVisionTransformer`:
`prepare_tokens_with_masks`, `interpolate_pos_encoding`, `forward_features`)
and `dinov2/layers/swiglu_ffn.py` (`SwiGLUFFNFused`) of
https://github.com/facebookresearch/dinov2, as `hub/backbones.py` builds
`dinov2_vitg14_reg`: the giant (1536 wide, 40 blocks of 24 heads), the fused
SwiGLU FFN, 4 register tokens, `interpolate_antialias=True`,
`interpolate_offset=0.0`, LayerScale. Per block

    x += ls1 · proj(attn(qkv(LN1 x)))
    x += ls2 · w3(silu(a) ⊙ b),   [a; b] = w12(LN2 x)

over the tokens [cls; registers; patches], the registers put in after the
position embedding is added to [cls; patches]; the output is the final
LayerNorm's patch tokens, without cls and registers. Module names are those
of the public checkpoint (without its `mask_token`), so the program's state
dict loads here as it is.

Departures from DINOv2:

- Input and output: NHWC images (B, H, W, 3) in, the patch tokens
  (`x_norm_patchtokens`) out, as the rest of the reference takes them.
- The resample of the position grid: DINOv2 passes `size=(w0, h0)` to
  `F.interpolate` on a (1, D, M, M) grid, so for a non-square image the
  grid it lays over the tokens has its sides swapped (its assert holds only
  because it checks the same swapped pair). Here the grid is resampled to
  (h0, w0), the tokens' own layout. Square images, the benchmark's, are
  the same either way.
- The products take their operands through `numerics.model`, so the
  control (`numerics.lowered()`) rounds them to fp8 as it does the head's;
  outside the control they are float32 as they are. The attention is
  `reference.ops.attention`, written out with the logits in full.
- Only what the `_reg` releases use is here: the fused SwiGLU FFN and
  the size-based resample (`interpolate_offset` 0); any other
  configuration raises.

Float32 products on the card run in float32, not TF32: constructing the
module sets `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` to False.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference import numerics
from portbench.reference.ops import attention

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The backbone's keys of a configuration's `dino_cfg`."""

    d_model: int = 1536
    depth: int = 40
    num_heads: int = 24
    patch_size: int = 14
    pos_embed_size: int = 37
    mlp_ratio: float = 4.0
    init_values: float = 1.0
    ffn_layer: str = "swiglufused"
    num_register_tokens: int = 4
    interpolate_antialias: bool = True
    interpolate_offset: float = 0.0

    @staticmethod
    def from_dict(dino: dict) -> "ViTConfig":
        names = {f.name for f in dataclasses.fields(ViTConfig)}
        return ViTConfig(**{k: v for k, v in dino.items() if k in names})


class Linear(nn.Linear):
    def forward(self, x: Tensor) -> Tensor:
        return F.linear(numerics.model(x), numerics.model(self.weight), self.bias)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: Tensor) -> Tensor:
        return x * self.gamma


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: Tensor) -> Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        return self.proj(attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(b, n, c))


class SwiGLUFFNFused(nn.Module):
    """`w3(silu(a) * b)`, [a; b] = `w12(x)`, hidden (int(h · 2/3) + 7) // 8 · 8."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        hidden = (int(hidden * 2 / 3) + 7) // 8 * 8
        self.w12 = Linear(dim, 2 * hidden)
        self.w3 = Linear(hidden, dim)

    def forward(self, x: Tensor) -> Tensor:
        a, b = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(a) * b)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d, hidden = cfg.d_model, int(cfg.d_model * cfg.mlp_ratio)
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = Attention(d, cfg.num_heads)
        self.ls1 = LayerScale(d, cfg.init_values)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = SwiGLUFFNFused(d, hidden)
        self.ls2 = LayerScale(d, cfg.init_values)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


def resample_pos_embed(pos: Tensor, gh: int, gw: int, base: int, antialias: bool) -> Tensor:
    """DINOv2's `interpolate_pos_encoding` of a (1, 1 + base², D) embedding
    to a gh × gw grid with `interpolate_offset` 0: bicubic by size, in
    float32."""
    if gh * gw == base * base and gh == gw:
        return pos
    d = pos.shape[-1]
    grid = pos[:, 1:].float().reshape(1, base, base, d).permute(0, 3, 1, 2)
    out = F.interpolate(grid, size=(gh, gw), mode="bicubic", antialias=antialias)
    return torch.cat([pos[:, :1], out.permute(0, 2, 3, 1).reshape(1, gh * gw, d).to(pos.dtype)], dim=1)


class VisionTransformer(nn.Module):
    """NHWC images (B, H, W, 3), sides multiples of the patch → the final
    LayerNorm's patch tokens (B, H/p · W/p, D)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.ffn_layer != "swiglufused" or cfg.interpolate_offset:
            raise ValueError("the reference takes the fused SwiGLU FFN and interpolate_offset 0 only")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        d, p = cfg.d_model, cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.pos_embed_size**2 + 1, d))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def forward(self, x: Tensor) -> Tensor:
        cfg = self.cfg
        b, h, w, _ = x.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        proj = self.patch_embed.proj
        tok = F.conv2d(numerics.model(x.permute(0, 3, 1, 2)), numerics.model(proj.weight), proj.bias,
                       stride=cfg.patch_size)
        tok = torch.cat([self.cls_token.expand(b, -1, -1), tok.flatten(2).transpose(1, 2)], dim=1)
        tok = tok + resample_pos_embed(self.pos_embed, gh, gw, cfg.pos_embed_size, cfg.interpolate_antialias)
        r = cfg.num_register_tokens
        if r:
            tok = torch.cat([tok[:, :1], self.register_tokens.expand(b, -1, -1), tok[:, 1:]], dim=1)
        for blk in self.blocks:
            tok = blk(tok)
        return self.norm(tok)[:, 1 + r:]
