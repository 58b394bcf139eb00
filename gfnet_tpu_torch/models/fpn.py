"""Full-resolution conv FPN encoder/decoder.

Counterpart of the plain path of `gfnet_tpu/models/fpn.py` (ref
`model/FPN.py`): conv → BatchNorm → activation blocks, NHWC. The BatchNorms
use batch statistics in train mode (`nn.Module.train()`) and running ones in
eval mode; their momentum is 0.1 (flax 0.9, `models/fpn.py:73`). The JAX package's space-to-depth branches are TPU lane-padding
lowerings of the same math and have no counterpart here. Module names follow
the reference state dict: the encoder's blocks hold `conv`/`bn`, the
decoder's and the merge layer's are `Sequential(conv, bn, act)` ("0", "1").
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn as nn

from gfnet_tpu_torch.models.common import Act, BatchNorm, Conv
from gfnet_tpu_torch.ops.resize import interpolate

Tensor = torch.Tensor


def conv_bn_act(in_ch: int, out_ch: int, kernel: int, stride: int = 1, act: str = "leaky_relu",
                conv_bias: bool = False, named: bool = False,
                dtype: torch.dtype = torch.bfloat16) -> nn.Sequential:
    """conv → BN (float32) → cast to dtype → activation (ref `model/FPN.py:95-128`).
    The encoder's convs drop their bias under BN (`FPN.py:113`), the
    decoder's and the merge layer's keep it (`FPN.py:43-52`)."""
    layers = [Conv(in_ch, out_ch, kernel, stride, bias=conv_bias, dtype=dtype),
              BatchNorm(out_ch, momentum=0.1), Act(act, dtype)]
    if named:
        return nn.Sequential(OrderedDict(zip(("conv", "bn", "act"), layers)))
    return nn.Sequential(*layers)


class FPNEncoder(nn.Module):
    """4-stage encoder, strides 1/2/4/8 (ref `model/FPN.py:5-36`);
    feat_chs fine→coarse, e.g. (8, 16, 32, 64)."""

    def __init__(self, feat_chs: Sequence[int], dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c0, c1, c2, c3 = feat_chs
        spec = [("conv00", 3, c0, 7, 1), ("conv01", c0, c0, 5, 1),
                ("downsample1", c0, c1, 5, 2), ("conv10", c1, c1, 3, 1), ("conv11", c1, c1, 3, 1),
                ("downsample2", c1, c2, 5, 2), ("conv20", c2, c2, 3, 1), ("conv21", c2, c2, 3, 1),
                ("downsample3", c2, c3, 3, 2), ("conv30", c3, c3, 3, 1), ("conv31", c3, c3, 3, 1)]
        for name, cin, cout, k, s in spec:
            self.add_module(name, conv_bn_act(cin, cout, k, s, named=True, dtype=dtype))

    def forward(self, x: Tensor) -> list[Tensor]:
        x = self.conv00(x)
        conv01 = self.conv01(x)
        x = self.conv10(self.downsample1(conv01))
        conv11 = self.conv11(x)
        x = self.conv20(self.downsample2(conv11))
        conv21 = self.conv21(x)
        x = self.conv30(self.downsample3(conv21))
        conv31 = self.conv31(x)
        return [conv01, conv11, conv21, conv31]


class FPNDecoder(nn.Module):
    """Top-down concat-fusion decoder (ref `model/FPN.py:39-69`): 4 levels at
    strides 8/4/2/1."""

    def __init__(self, feat_chs: Sequence[int], dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c0, c1, c2, c3 = feat_chs
        blk = lambda cin, cout, k: conv_bn_act(cin, cout, k, act="swish", conv_bias=True, dtype=dtype)
        self.out0 = blk(c3, c3, 1)
        self.inner1 = blk(c3 + c2, c2, 3)
        self.out1 = blk(c2, c2, 1)
        self.inner2 = blk(c2 + c1, c1, 3)
        self.out2 = blk(c1, c1, 1)
        self.inner3 = blk(c1 + c0, c0, 3)
        self.out3 = blk(c0, c0, 1)
        self.compute_dtype = dtype

    def _up_cat(self, t: Tensor, skip: Tensor) -> Tensor:
        # float32 bilinear x2 upsample (the reference casts, `FPN.py:59`)
        up = interpolate(t.float(), skip.shape[1:3], "bilinear", False).to(self.compute_dtype)
        return torch.cat([up, skip], dim=-1)

    def forward(self, conv01: Tensor, conv11: Tensor, conv21: Tensor, conv31: Tensor) -> list[Tensor]:
        intra = conv31
        out0 = self.out0(intra)
        intra = conv21 + self.inner1(self._up_cat(intra, conv21))
        out1 = self.out1(intra)
        intra = conv11 + self.inner2(self._up_cat(intra, conv11))
        out2 = self.out2(intra)
        intra = conv01 + self.inner3(self._up_cat(intra, conv01))
        out3 = self.out3(intra)
        return [out0, out1, out2, out3]
