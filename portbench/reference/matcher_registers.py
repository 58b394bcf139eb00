"""The reference matcher on a DINOv2 backbone with registers.

`RegisterReference` is `matcher.Reference` with its ViT taken from
`vit_registers.py` (registers, the fused SwiGLU, the size-based
antialiased resample) and its head from `models.GFNet`, unchanged: the
cross-view decoder reads the backbone's width from the configuration. The
passes, stitch, sampling and solve are `Reference`'s own.
"""

from __future__ import annotations

import torch

from portbench.reference.matcher import Reference
from portbench.reference.models import GFNet
from portbench.reference.vit_registers import ViTConfig, VisionTransformer


class RegisterReference(Reference):
    """The model in float32 on `device`: `cfg` the reference's
    `ModelConfig`, `vit_cfg` the backbone's `ViTConfig`."""

    def __init__(self, cfg, vit_cfg: ViTConfig, vit_state: dict, head_state: dict, device):
        self.cfg = cfg
        self.device = torch.device(device)
        vit = VisionTransformer(vit_cfg)
        vit.load_state_dict({k: v.float() for k, v in vit_state.items()})
        head = GFNet(cfg)
        head.load_state_dict({k: v.float() for k, v in head_state.items()})
        self.vit = vit.to(self.device).eval().requires_grad_(False)
        self.head = head.to(self.device).eval().requires_grad_(False)
