"""Cross-view transformer decoder over ViT-grid tokens.

Counterpart of `gfnet_tpu/models/crossview.py` (ref
`model/crossview_decoder_light.py:12-111`, `layers/block.py:255-329`,
`layers/attention.py:173-258`). Each block applies to both directions with
shared weights: x attends to y and y attends to x. The two directions are
stacked on the batch axis, so each block launches kernel K1 once for both.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gfnet_tpu_torch.config import DecoderConfig
from gfnet_tpu_torch.models.common import Dense, LayerNorm, LayerScale, gelu
from gfnet_tpu_torch.ops.attention import entropy_invariant_scale, fused_attention, linear_attention

Tensor = torch.Tensor


@lru_cache(maxsize=32)
def sine_position_encoding(d_model: int, h: int, w: int, max_shape=(128, 128)) -> np.ndarray:
    """2D sinusoidal PE normalized to max_shape (ref
    `crossview_decoder_light.py:84-97`). Returns (h, w, d_model) float32."""
    pe = np.zeros((d_model, h, w), np.float32)
    y_pos = np.cumsum(np.ones((h, w), np.float32), axis=0) * max_shape[0] / h
    x_pos = np.cumsum(np.ones((h, w), np.float32), axis=1) * max_shape[1] / w
    div = np.exp(
        np.arange(0, d_model // 2, 2, dtype=np.float32) * (-np.log(10000.0) / (d_model // 2))
    )[:, None, None]
    pe[0::4] = np.sin(x_pos[None] * div)
    pe[1::4] = np.cos(x_pos[None] * div)
    pe[2::4] = np.sin(y_pos[None] * div)
    pe[3::4] = np.cos(y_pos[None] * div)
    return np.transpose(pe, (1, 2, 0))


class CrossAttention(nn.Module):
    """Separate q/k/v projections without bias, output projection with bias,
    entropy-invariant scale (ref `attention.py:173-224`)."""

    def __init__(self, dim: int, num_heads: int, train_avg_length: int | None,
                 attention_type: str, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.train_avg_length = train_avg_length
        self.attention_type = attention_type
        self.q_proj = Dense(dim, dim, bias=False, dtype=dtype)
        self.k_proj = Dense(dim, dim, bias=False, dtype=dtype)
        self.v_proj = Dense(dim, dim, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: Tensor, key: Tensor, value: Tensor) -> Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        q = self.q_proj(x).reshape(b, n, self.num_heads, hd)
        k = self.k_proj(key).reshape(b, -1, self.num_heads, hd)
        v = self.v_proj(value).reshape(b, -1, self.num_heads, hd)
        if self.attention_type == "Linear":
            out = linear_attention(q, k, v)
        else:
            scale = entropy_invariant_scale(hd, n, self.train_avg_length)
            out = fused_attention(q, k, v, scale=scale)
        return self.proj(out.reshape(b, n, c))


def _std_norm(t: Tensor) -> Tensor:
    """Parameter-free standardization over channels (population variance)."""
    tf = t.float()
    mean = tf.mean(-1, keepdim=True)
    var = tf.var(-1, keepdim=True, unbiased=False)
    return ((tf - mean) * torch.rsqrt(var + 1e-6)).to(t.dtype)


class CrossBlock(nn.Module):
    """Cross block, pre-norm or post-norm (ref `block.py:255-329`).

    Module names follow the reference state dict (`mlp.fc1`/`mlp.fc2`, or
    `mlp.w12`/`mlp.w3` for the SwiGLU FFN).
    """

    def __init__(self, dim: int, num_heads: int, cfg: DecoderConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        train_len = cfg.train_avg_length if cfg.softmax_scale == "entropy_invariance" else None
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.attn = CrossAttention(dim, num_heads, train_len, cfg.attention_type, dtype)
        self.ls1 = LayerScale(dim, cfg.init_values)
        self.ls2 = LayerScale(dim, cfg.init_values)
        hidden = int(dim * cfg.mlp_ratio)
        self.mlp = nn.Module()
        if cfg.ffn_type == "glu":
            self.mlp.w12 = Dense(dim, 2 * hidden, dtype=dtype)
            self.mlp.w3 = Dense(hidden, dim, dtype=dtype)
        else:
            self.mlp.fc1 = Dense(dim, hidden, dtype=dtype)
            self.mlp.fc2 = Dense(hidden, dim, dtype=dtype)

    def _mlp(self, h: Tensor) -> Tensor:
        if self.cfg.ffn_type == "glu":
            x1, x2 = self.mlp.w12(h).chunk(2, dim=-1)
            return self.mlp.w3(F.silu(x1) * x2)
        return self.mlp.fc2(gelu(self.mlp.fc1(h)))

    def forward(self, x: Tensor, key: Tensor, value: Tensor) -> Tensor:
        cfg = self.cfg
        if cfg.post_norm:
            x = self.norm1(x + self.ls1(self.attn(x, key, value)))
            return self.norm2(x + self.ls2(self._mlp(x)))
        if not cfg.pre_norm_query:
            xq, key, value = self.norm1(x), self.norm1(key), self.norm1(value)
        else:
            xq = self.norm1(x)
            if cfg.kv_norm:
                key, value = _std_norm(key), _std_norm(value)
        x = x + self.ls1(self.attn(xq, key, value))
        return x + self.ls2(self._mlp(self.norm2(x)))


class CrossViewDecoder(nn.Module):
    """Bidirectional cross-view decoder (ref `crossview_decoder_light.py:12-62`):
    the two views' patch tokens (B, H*W, d_vit) → per-view NHWC feature maps
    (B, H, W, out_dim)."""

    def __init__(self, d_vit: int, out_dim: int, cfg: DecoderConfig, dtype: torch.dtype):
        super().__init__()
        self.out_dim = out_dim
        self.proj = Dense(d_vit, out_dim, bias=False, dtype=dtype)
        self.cross_attn_blocks = nn.ModuleList(
            CrossBlock(out_dim, cfg.nhead, cfg, dtype) for _ in range(cfg.num_cross_attn)
        )
        self.compute_dtype = dtype

    def forward(self, x: Tensor, y: Tensor, grid_hw: tuple[int, int]) -> tuple[Tensor, Tensor]:
        h, w = grid_hw
        b = x.shape[0]
        pe = torch.from_numpy(sine_position_encoding(self.out_dim, h, w)).to(x.device)
        pe = pe.reshape(1, h * w, -1).to(self.compute_dtype)
        # both directions at once: queries [x; y] attend to keys [y; x]
        xy = self.proj(torch.cat([x, y], dim=0)) + pe
        for blk in self.cross_attn_blocks:
            yx = torch.cat([xy[b:], xy[:b]], dim=0)
            xy = blk(xy, yx, yx)
        xy = xy.reshape(2 * b, h, w, self.out_dim)
        return xy[:b], xy[b:]
