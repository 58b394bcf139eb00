"""The GFNet model in plain PyTorch, eval mode: the DINOv2 ViT, the
cross-view decoder, the FPN, the global correlation and the coarse-to-fine
refiners. Module names are those of the port's state dicts, so one state
dict loads into both. Every layer computes in float32 (`numerics.model`
lowers the operands of its products for the control).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference import numerics
from portbench.reference.ops import (attention, corr_volume_flow, entropy_invariant_scale,
                                     grid_sample, interpolate, local_correlation, normalized_grid)

Tensor = torch.Tensor
SCALES = ("16", "8", "4", "2", "1")


# ------------------------------------------------------------------- layers
class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: Tensor) -> Tensor:
        return x * self.gamma


class Dense(nn.Linear):
    def forward(self, x: Tensor) -> Tensor:
        return F.linear(numerics.model(x), numerics.model(self.weight), self.bias)


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)


class Conv(nn.Module):
    """Convolution of NHWC input with an OIHW weight, k // 2 padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 bias: bool = True, depthwise: bool = False):
        super().__init__()
        self.groups = in_ch if depthwise else 1
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // self.groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride, self.padding = stride, kernel // 2

    def forward(self, x: Tensor) -> Tensor:
        y = F.conv2d(numerics.model(x).permute(0, 3, 1, 2), numerics.model(self.weight), self.bias,
                     stride=self.stride, padding=self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Normalization by the running statistics over the last axis."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: Tensor) -> Tensor:
        return (x - self.running_mean) * (self.weight * torch.rsqrt(self.running_var + 1e-5)) + self.bias


class Act(nn.Module):
    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind

    def forward(self, x: Tensor) -> Tensor:
        if self.kind == "relu":
            return F.relu(x)
        if self.kind == "leaky_relu":
            return F.leaky_relu(x, 0.1)
        return x * torch.sigmoid(x)  # swish


# ---------------------------------------------------------------------- ViT
class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x: Tensor) -> Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        out = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(out.reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class VisionTransformer(nn.Module):
    """DINOv2: NHWC images → the final-LN patch tokens without cls. The
    patch grid's position embedding is resampled bicubically with DINOv2's
    +0.1 offset."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.ffn_layer != "mlp":
            raise ValueError(f"the reference has no {cfg.ffn_layer!r} FFN")
        self.cfg = cfg
        d, p = cfg.d_model, cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv(3, d, p, stride=p)
        self.patch_embed.proj.padding = 0
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.pos_embed_size**2 + 1, d))
        self.blocks = nn.ModuleList(Block(d, cfg.num_heads, cfg.mlp_ratio) for _ in range(cfg.depth))
        self.norm = LayerNorm(d)

    def _pos(self, gh: int, gw: int) -> Tensor:
        base = self.cfg.pos_embed_size
        pos = self.pos_embed
        if gh * gw == base * base and gh == gw:
            return pos
        grid = pos[:, 1:].reshape(1, base, base, -1)
        out = interpolate(grid, (gh, gw), "bicubic", False, scale=((gh + 0.1) / base, (gw + 0.1) / base))
        return torch.cat([pos[:, :1], out.reshape(1, gh * gw, -1)], dim=1)

    def forward(self, x: Tensor) -> Tensor:
        b, h, w, _ = x.shape
        p = self.cfg.patch_size
        gh, gw = h // p, w // p
        tok = self.patch_embed.proj(x).reshape(b, gh * gw, -1)
        tok = torch.cat([self.cls_token.expand(b, 1, -1), tok], dim=1) + self._pos(gh, gw)
        for blk in self.blocks:
            tok = blk(tok)
        return self.norm(tok)[:, 1:]


# ------------------------------------------------------- cross-view decoder
def sine_position_encoding(d_model: int, h: int, w: int, max_shape=(128, 128)) -> np.ndarray:
    """2-D sinusoidal encoding normalized to `max_shape`, (h, w, d_model)."""
    pe = np.zeros((d_model, h, w), np.float32)
    y_pos = np.cumsum(np.ones((h, w), np.float32), axis=0) * max_shape[0] / h
    x_pos = np.cumsum(np.ones((h, w), np.float32), axis=1) * max_shape[1] / w
    div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32)
                 * (-np.log(10000.0) / (d_model // 2)))[:, None, None]
    pe[0::4] = np.sin(x_pos[None] * div)
    pe[1::4] = np.cos(x_pos[None] * div)
    pe[2::4] = np.sin(y_pos[None] * div)
    pe[3::4] = np.cos(y_pos[None] * div)
    return np.transpose(pe, (1, 2, 0))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, train_avg_length: int | None):
        super().__init__()
        self.num_heads, self.train_avg_length = num_heads, train_avg_length
        self.q_proj = Dense(dim, dim, bias=False)
        self.k_proj = Dense(dim, dim, bias=False)
        self.v_proj = Dense(dim, dim, bias=False)
        self.proj = Dense(dim, dim)

    def forward(self, x: Tensor, key: Tensor, value: Tensor) -> Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        q = self.q_proj(x).reshape(b, n, self.num_heads, hd)
        k = self.k_proj(key).reshape(b, -1, self.num_heads, hd)
        v = self.v_proj(value).reshape(b, -1, self.num_heads, hd)
        out = attention(q, k, v, entropy_invariant_scale(hd, n, self.train_avg_length))
        return self.proj(out.reshape(b, n, c))


def _std_norm(t: Tensor) -> Tensor:
    """Standardization over channels, population variance."""
    mean = t.mean(-1, keepdim=True)
    var = t.var(-1, keepdim=True, unbiased=False)
    return (t - mean) * torch.rsqrt(var + 1e-6)


class CrossBlock(nn.Module):
    def __init__(self, dim: int, cfg):
        super().__init__()
        if cfg.ffn_type != "ffn" or cfg.attention_type == "Linear":
            raise ValueError("the reference has the FFN decoder with softmax attention only")
        self.cfg = cfg
        train_len = cfg.train_avg_length if cfg.softmax_scale == "entropy_invariance" else None
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.attn = CrossAttention(dim, cfg.nhead, train_len)
        self.ls1 = LayerScale(dim)
        self.ls2 = LayerScale(dim)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio))

    def forward(self, x: Tensor, key: Tensor, value: Tensor) -> Tensor:
        cfg = self.cfg
        if cfg.post_norm:
            x = self.norm1(x + self.ls1(self.attn(x, key, value)))
            return self.norm2(x + self.ls2(self.mlp(x)))
        if not cfg.pre_norm_query:
            xq, key, value = self.norm1(x), self.norm1(key), self.norm1(value)
        else:
            xq = self.norm1(x)
            if cfg.kv_norm:
                key, value = _std_norm(key), _std_norm(value)
        x = x + self.ls1(self.attn(xq, key, value))
        return x + self.ls2(self.mlp(self.norm2(x)))


class CrossViewDecoder(nn.Module):
    """Both views' patch tokens → per-view NHWC maps; x attends to y and y
    to x through shared blocks."""

    def __init__(self, d_vit: int, out_dim: int, cfg):
        super().__init__()
        self.out_dim = out_dim
        self.proj = Dense(d_vit, out_dim, bias=False)
        self.cross_attn_blocks = nn.ModuleList(CrossBlock(out_dim, cfg) for _ in range(cfg.num_cross_attn))

    def forward(self, x: Tensor, y: Tensor, grid_hw: tuple[int, int]) -> tuple[Tensor, Tensor]:
        h, w = grid_hw
        b = x.shape[0]
        pe = torch.from_numpy(sine_position_encoding(self.out_dim, h, w)).to(x.device).reshape(1, h * w, -1)
        xy = self.proj(torch.cat([x, y], dim=0)) + pe
        for blk in self.cross_attn_blocks:
            yx = torch.cat([xy[b:], xy[:b]], dim=0)
            xy = blk(xy, yx, yx)
        xy = xy.reshape(2 * b, h, w, self.out_dim)
        return xy[:b], xy[b:]


# ---------------------------------------------------------------------- FPN
def conv_bn_act(in_ch: int, out_ch: int, kernel: int, stride: int = 1, act: str = "leaky_relu",
                conv_bias: bool = False, named: bool = False) -> nn.Sequential:
    layers = [Conv(in_ch, out_ch, kernel, stride, bias=conv_bias), BatchNorm(out_ch), Act(act)]
    if named:
        return nn.Sequential(OrderedDict(zip(("conv", "bn", "act"), layers)))
    return nn.Sequential(*layers)


class FPNEncoder(nn.Module):
    def __init__(self, feat_chs):
        super().__init__()
        c0, c1, c2, c3 = feat_chs
        spec = [("conv00", 3, c0, 7, 1), ("conv01", c0, c0, 5, 1),
                ("downsample1", c0, c1, 5, 2), ("conv10", c1, c1, 3, 1), ("conv11", c1, c1, 3, 1),
                ("downsample2", c1, c2, 5, 2), ("conv20", c2, c2, 3, 1), ("conv21", c2, c2, 3, 1),
                ("downsample3", c2, c3, 3, 2), ("conv30", c3, c3, 3, 1), ("conv31", c3, c3, 3, 1)]
        for name, cin, cout, k, s in spec:
            self.add_module(name, conv_bn_act(cin, cout, k, s, named=True))

    def forward(self, x: Tensor) -> list[Tensor]:
        conv01 = self.conv01(self.conv00(x))
        conv11 = self.conv11(self.conv10(self.downsample1(conv01)))
        conv21 = self.conv21(self.conv20(self.downsample2(conv11)))
        conv31 = self.conv31(self.conv30(self.downsample3(conv21)))
        return [conv01, conv11, conv21, conv31]


class FPNDecoder(nn.Module):
    def __init__(self, feat_chs):
        super().__init__()
        c0, c1, c2, c3 = feat_chs
        blk = lambda cin, cout, k: conv_bn_act(cin, cout, k, act="swish", conv_bias=True)
        self.out0 = blk(c3, c3, 1)
        self.inner1 = blk(c3 + c2, c2, 3)
        self.out1 = blk(c2, c2, 1)
        self.inner2 = blk(c2 + c1, c1, 3)
        self.out2 = blk(c1, c1, 1)
        self.inner3 = blk(c1 + c0, c0, 3)
        self.out3 = blk(c0, c0, 1)

    @staticmethod
    def _up_cat(t: Tensor, skip: Tensor) -> Tensor:
        return torch.cat([interpolate(t, skip.shape[1:3], "bilinear", False), skip], dim=-1)

    def forward(self, conv01, conv11, conv21, conv31) -> list[Tensor]:
        intra = conv31
        out0 = self.out0(intra)
        intra = conv21 + self.inner1(self._up_cat(intra, conv21))
        out1 = self.out1(intra)
        intra = conv11 + self.inner2(self._up_cat(intra, conv11))
        out2 = self.out2(intra)
        intra = conv01 + self.inner3(self._up_cat(intra, conv01))
        return [out0, out1, out2, self.out3(intra)]


# ------------------------------------------------------------------ refiner
def refine_block(features: int, kernel: int) -> nn.Sequential:
    """depthwise k x k conv → BN → ReLU → 1x1 conv."""
    return nn.Sequential(Conv(features, features, kernel, depthwise=True), BatchNorm(features),
                         Act("relu"), Conv(features, features, 1))


class ConvRefiner(nn.Module):
    """One scale's refinement: the target warped by the flow, the query on
    the G x G grid, the embedded displacement and the local correlation →
    (Δflow, Δcertainty)."""

    def __init__(self, hidden_dim: int, displacement_dim: int, radius: int,
                 hidden_blocks: int = 8, kernel_size: int = 5):
        super().__init__()
        self.hidden_dim, self.radius = hidden_dim, radius
        self.disp_emb = Conv(2, displacement_dim, 1)
        self.block1 = refine_block(hidden_dim, kernel_size)
        self.hidden_blocks = nn.Sequential(*(refine_block(hidden_dim, kernel_size) for _ in range(hidden_blocks)))
        self.out_conv = Conv(hidden_dim, 3, 1)

    def forward(self, query_feat: Tensor, target_feat: Tensor, flow: Tensor,
                scale_factor: float = 1.0) -> tuple[Tensor, Tensor]:
        g = flow.shape[1]
        x_hat = grid_sample(target_feat, flow)
        grid_feature = interpolate(query_feat, (g, g), "bilinear", False)
        grid = normalized_grid(g, g, device=flow.device)[None]
        feats = [grid_feature, x_hat, self.disp_emb(40.0 / 32.0 * scale_factor * (flow - grid))]
        if self.radius > 0:
            feats.append(local_correlation(grid_feature, target_feat, flow, self.radius))
        d = self.hidden_blocks(self.block1(torch.cat(feats, dim=-1)))
        out = self.out_conv(d)
        return out[..., :2], out[..., 2:3]


# --------------------------------------------------------------------- head
class GFNet(nn.Module):
    """The matching head: everything but the ViT, which it takes the
    tokens of."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        fd = tuple(cfg.encoder.feat_chs)
        self.dino_decoder = CrossViewDecoder(cfg.dino.d_model, fd[0], cfg.dino.decoder_cfg)
        self.encoder = FPNEncoder(fd[::-1])
        self.decoder = FPNDecoder(fd[::-1])
        self.merge_layer = conv_bn_act(2 * fd[0], fd[0], 3, act="swish", conv_bias=True)
        feat_at_scale = {"16": fd[0], "8": fd[0], "4": fd[1], "2": fd[2], "1": fd[3]}
        refiners = {}
        for i, scale in enumerate(SCALES):
            r = cfg.matcher.radius[i]
            k = (2 * r + 1) ** 2 if r > 0 else 0
            disp = cfg.matcher.displacement_dim[i]
            refiners[scale] = ConvRefiner(2 * feat_at_scale[scale] + disp + k, disp, r)
        self.conv_refiner = nn.ModuleDict(refiners)

    def extract_features(self, x: Tensor, vit_tokens: Tensor, grid_hw, upsample: bool):
        twob, h, w, _ = x.shape
        b = twob // 2
        vit0, vit1 = self.dino_decoder(vit_tokens[:b], vit_tokens[b:], grid_hw)
        vit_feat = torch.cat([vit0, vit1], dim=0)
        vit_up = interpolate(vit_feat, (h // 8, w // 8), "bilinear", False)
        conv01, conv11, conv21, conv31 = self.encoder(x)
        merged = self.merge_layer(torch.cat([conv31, vit_up], dim=-1))
        feats = self.decoder(conv01, conv11, conv21, conv31 + merged)
        pyr = dict(zip(SCALES, [vit_feat, *feats]))
        if upsample:
            del pyr["16"]
        return {s: t[:b] for s, t in pyr.items()}, {s: t[b:] for s, t in pyr.items()}

    def forward(self, im_A: Tensor, im_B: Tensor, vit_tokens: Tensor, symmetric: bool,
                upsample: bool = False, scale_factor: float = 1.0, pre_flow: Tensor | None = None,
                pre_certainty: Tensor | None = None, num_grid=None) -> dict:
        cfg = self.cfg
        _, h0, w0, _ = im_A.shape
        gh, gw = h0 // cfg.dino.patch_size, w0 // cfg.dino.patch_size
        f0s, f1s = self.extract_features(torch.cat([im_A, im_B]), vit_tokens, (gh, gw), upsample)
        scales = [s for s in SCALES if s in f0s]
        if symmetric:
            f0s, f1s = ({s: torch.cat([f0s[s], f1s[s]]) for s in scales},
                        {s: torch.cat([f1s[s], f0s[s]]) for s in scales})
        num_itr = cfg.matcher.num_itr[-len(scales):]
        num_grid = num_grid if upsample else cfg.matcher.num_grid
        corresps: dict = {}
        for idx, scale in enumerate(scales):
            f0, f1 = f0s[scale], f1s[scale]
            g = num_grid[idx]
            if idx == 0:
                if upsample:
                    flow = interpolate(pre_flow, (g, g), "bilinear", False)
                    certainty = interpolate(pre_certainty, (g, g), "bilinear", False)
                else:
                    flow = corr_volume_flow(f0, f1)
                    certainty = torch.zeros(flow.shape[:-1] + (1,), dtype=flow.dtype, device=flow.device)
            corresps[scale] = {}
            displacement_pre = torch.zeros_like(flow) + 1e-7
            for itr in range(num_itr[idx]):
                delta_flow, delta_cert = self.conv_refiner[scale](f0, f1, flow, scale_factor=scale_factor)
                displacement = float(int(scale)) * torch.stack(
                    [delta_flow[..., 0] / (4 * w0), delta_flow[..., 1] / (4 * h0)], dim=-1)
                # a displacement that has converged is zeroed, as at inference
                rel = (displacement - displacement_pre).abs() / displacement_pre.abs()
                displacement = torch.where(rel < 1e-6, torch.zeros_like(displacement), displacement)
                flow = flow + displacement
                certainty = certainty + delta_cert
                corresps[scale][itr + 1] = {"flow": flow, "certainty": certainty}
                displacement_pre = displacement
            if scale != "1":
                g_next = num_grid[idx + 1]
                flow = interpolate(flow, (g_next, g_next), "bilinear", False)
                certainty = interpolate(certainty, (g_next, g_next), "bilinear", False)
        return corresps
