"""The seeded DINOv2 ViT with registers that both sides of a register cell
are handed.

Drawn as DINOv2 initialises its backbones (`DinoVisionTransformer.init_weights`
and `init_weights_vit_timm` of `dinov2/models/vision_transformer.py`), from
one seeded torch generator on the CPU, leaf after leaf in the order below:
the position embedding truncated normal (std 0.02, cut at ±2), the cls
and register tokens normal (std 1e-6), the patch embedding as torch's
`Conv2d` draws it (uniform on ±1/√fan_in, bias too), then block by block
each `Linear`'s weight truncated normal (std 0.02, cut at ±2) with a zero
bias; LayerNorms at one and zero, LayerScale at `init_values`. The public
checkpoint's weights are not in the repository, so a cell runs on this
draw. It is made once a checkout and kept in bf16, the type it is served
in, under `portbench/.cache/`, keyed by this file's hash and the
configuration.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from pathlib import Path

import torch

CACHE = Path(__file__).resolve().parent / ".cache"
SEED = 0


def _trunc_normal(shape, g: torch.Generator) -> torch.Tensor:
    return torch.nn.init.trunc_normal_(torch.empty(shape), std=0.02, a=-2.0, b=2.0, generator=g)


def _uniform(shape, bound: float, g: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=g)


def draw_vit(dino: dict, seed: int = SEED) -> dict:
    """The ViT of `dino` (a configuration's `dino_cfg`: d_model, depth,
    patch_size, pos_embed_size, mlp_ratio, init_values, ffn_layer,
    num_register_tokens) as a state dict of float32 tensors."""
    g = torch.Generator().manual_seed(seed)
    d, p, depth = dino["d_model"], dino["patch_size"], dino["depth"]
    if dino["ffn_layer"] != "swiglufused":
        raise ValueError(f"DINOv2's giant draws a fused SwiGLU FFN, not {dino['ffn_layer']!r}")
    hf = (int(int(d * dino["mlp_ratio"]) * 2 / 3) + 7) // 8 * 8
    sd = {"pos_embed": _trunc_normal((1, dino["pos_embed_size"] ** 2 + 1, d), g),
          "cls_token": torch.randn((1, 1, d), generator=g) * 1e-6}
    if dino.get("num_register_tokens", 0):
        sd["register_tokens"] = torch.randn((1, dino["num_register_tokens"], d), generator=g) * 1e-6
    bound = 1.0 / math.sqrt(3 * p * p)
    sd["patch_embed.proj.weight"] = _uniform((d, 3, p, p), bound, g)
    sd["patch_embed.proj.bias"] = _uniform((d,), bound, g)
    linears = {"attn.qkv": (3 * d, d), "attn.proj": (d, d), "mlp.w12": (2 * hf, d), "mlp.w3": (d, hf)}
    for i in range(depth):
        t = f"blocks.{i}."
        for name in ("norm1", "norm2"):
            sd[t + name + ".weight"], sd[t + name + ".bias"] = torch.ones(d), torch.zeros(d)
        sd[t + "ls1.gamma"] = torch.full((d,), float(dino["init_values"]))
        sd[t + "ls2.gamma"] = torch.full((d,), float(dino["init_values"]))
        for name, shape in linears.items():
            sd[t + name + ".weight"] = _trunc_normal(shape, g)
            sd[t + name + ".bias"] = torch.zeros(shape[0])
    sd["norm.weight"], sd["norm.bias"] = torch.ones(d), torch.zeros(d)
    return sd


def vit_state(dino: dict) -> dict:
    """The seeded ViT in bf16 on the host, drawn once and kept in `CACHE`."""
    tag = hashlib.sha256(Path(__file__).read_bytes() + json.dumps(dino, sort_keys=True).encode())
    path = CACHE / f"vitreg-{tag.hexdigest()[:16]}.pt"
    if not path.exists():
        CACHE.mkdir(parents=True, exist_ok=True)
        state = {k: v.to(torch.bfloat16) for k, v in draw_vit(dino).items()}
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        torch.save(state, tmp)
        os.replace(tmp, path)
    return torch.load(path, map_location="cpu", mmap=True)
