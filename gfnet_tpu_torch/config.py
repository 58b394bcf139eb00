"""Typed configuration for the PyTorch port of the GFNet engine.

An own copy of the JAX package's configuration (`gfnet_tpu/config.py`): the
same dataclasses (`TrainConfig` included), the same reference-JSON schema
(`ModelConfig.from_json`) and the same `tiny_test_config`. One field is new: `DecoderConfig.kv_norm`
carries the parameter-free k/v standardization that the JAX package reads
from the `GFNET_KV_NORM` environment variable (`models/crossview.py:138`).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Cross-view ViT decoder config (ref `gfnet_configs/basic.json` dino_cfg.decoder_cfg)."""

    num_cross_attn: int = 4
    init_values: float = 1.0
    nhead: int = 8
    attention_type: str = "FLASH2"
    ffn_type: str = "ffn"
    softmax_scale: str | None = "entropy_invariance"
    train_avg_length: int = 1024
    post_norm: bool = False
    pre_norm_query: bool = True
    mlp_ratio: float = 4.0
    # Standardize the un-normalized k/v stream (pre_norm_query only). Heads
    # trained with it carry `__protocol_kv_norm__` in their .npz.
    kv_norm: bool = False


@dataclasses.dataclass(frozen=True)
class DinoConfig:
    """Frozen DINOv2 backbone config (ref `model/network.py:46-54`)."""

    d_model: int = 1024
    depth: int = 24
    num_heads: int = 16
    patch_size: int = 14
    pos_embed_size: int = 37  # 518 // 14, ref `model/network.py:48`
    mlp_ratio: float = 4.0
    init_values: float = 1.0  # LayerScale
    # "mlp" or "swiglufused" (ref `dinov2.py:84,107-116`)
    ffn_layer: str = "mlp"
    # DINOv2 with registers (arXiv:2309.16588): learned tokens inserted after
    # cls once the position embedding is added, dropped from the output
    num_register_tokens: int = 0
    # the pos-embed resample: +offset scale-based (0.1, the ViT-L release), or
    # size-based where the offset is 0, antialiased as the `_reg` releases
    interpolate_antialias: bool = False
    interpolate_offset: float = 0.1
    decoder_cfg: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)

    def __post_init__(self):
        # DINOv2 antialiases in both modes; the port's scale-based resample
        # has no antialiased form, so that pair would silently differ
        if self.interpolate_antialias and self.interpolate_offset:
            raise ValueError("interpolate_antialias is implemented for interpolate_offset 0 only")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """FPN encoder config, feat_chs coarse→fine as in the reference."""

    feat_chs: Sequence[int] = (64, 32, 16, 8)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Coarse-to-fine matcher config; lists are coarse→fine over scales
    ["16", "8", "4", "2", "1"]."""

    num_grid: Sequence[int] = (32, 32, 64, 128, 256)
    radius: Sequence[int] = (7, 6, 4, 2, 0)
    displacement_dim: Sequence[int] = (64, 64, 32, 16, 8)
    num_itr: Sequence[int] = (1, 1, 1, 1, 1)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    dino: DinoConfig = dataclasses.field(default_factory=DinoConfig)
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    initial_res: tuple[int, int] = (448, 448)
    upsample_res: tuple[int, int] = (560, 560)
    symmetric: bool = True
    upsample_preds: bool = True
    attenuate_cert: bool = True
    sample_mode: str = "threshold_balanced"
    sample_thresh: float = 0.05
    amp: bool = True  # bf16 compute (the reference uses fp16 autocast)

    @staticmethod
    def from_json(path: str | Path, **overrides) -> "ModelConfig":
        """Load a reference-format experiment JSON (e.g. basic.json)."""
        with open(path) as f:
            raw = json.load(f)
        return ModelConfig.from_dict(raw, **overrides)

    @staticmethod
    def from_dict(raw: dict, **overrides) -> "ModelConfig":
        dcfg = raw.get("dino_cfg", {})
        dec = dcfg.get("decoder_cfg", {})
        decoder = DecoderConfig(
            num_cross_attn=dec.get("num_cross_attn", 4),
            init_values=dec.get("init_values", 1.0),
            nhead=dec.get("nhead", 8),
            attention_type=dec.get("attention_type", "FLASH2"),
            ffn_type=dec.get("ffn_type", "ffn"),
            softmax_scale=dec.get("softmax_scale", "entropy_invariance"),
            train_avg_length=dec.get("train_avg_length", 1024),
            post_norm=dec.get("post_norm", False),
            pre_norm_query=dec.get("pre_norm_query", True),
            kv_norm=dec.get("kv_norm", False),
        )
        # depth/num_heads/... extend the reference schema, which carries only
        # d_model + decoder_cfg; reference JSONs keep the ViT-L defaults.
        dino = DinoConfig(
            d_model=dcfg.get("d_model", 1024),
            depth=dcfg.get("depth", 24),
            num_heads=dcfg.get("num_heads", 16),
            patch_size=dcfg.get("patch_size", 14),
            pos_embed_size=dcfg.get("pos_embed_size", 37),
            ffn_layer=dcfg.get("ffn_layer", "mlp"),
            num_register_tokens=dcfg.get("num_register_tokens", 0),
            interpolate_antialias=dcfg.get("interpolate_antialias", False),
            interpolate_offset=dcfg.get("interpolate_offset", 0.1),
            decoder_cfg=decoder,
        )
        enc = EncoderConfig(feat_chs=tuple(raw.get("encoder_cfg", {}).get("feat_chs", (64, 32, 16, 8))))
        m = raw.get("matcher", {})
        matcher = MatcherConfig(
            num_grid=tuple(m.get("num_grid", (32, 32, 64, 128, 256))),
            radius=tuple(m.get("radius", (7, 6, 4, 2, 0))),
            displacement_dim=tuple(m.get("displacement_dim", (64, 64, 32, 16, 8))),
            num_itr=tuple(m.get("num_itr", (1, 1, 1, 1, 1))),
        )
        extra = {}
        for k in ("initial_res", "upsample_res"):
            if k in raw:
                extra[k] = tuple(raw[k])
        for k in ("symmetric", "upsample_preds", "attenuate_cert"):
            if k in raw:
                extra[k] = raw[k]
        cfg = ModelConfig(dino=dino, encoder=enc, matcher=matcher, **extra)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return cfg

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_kv_norm(self, kv_norm: bool) -> "ModelConfig":
        """Copy with the decoder's k/v standardization switched."""
        dec = dataclasses.replace(self.dino.decoder_cfg, kv_norm=bool(kv_norm))
        return self.replace(dino=dataclasses.replace(self.dino, decoder_cfg=dec))

    def with_head_kv_norm(self, flag: bool | None) -> "ModelConfig":
        """Copy with the k/v standardization a head file asks for: the
        config's flag stays, and a file's `True` turns it on (JAX's
        `GFNET_KV_NORM=1` OR the file's `__protocol_kv_norm__`). `flag` is
        `load_head`'s: None where the file says nothing."""
        return self.with_kv_norm(self.dino.decoder_cfg.kv_norm or bool(flag))


def tiny_test_config() -> ModelConfig:
    """A CPU-runnable miniature of the architecture for unit tests: the same
    topology (5 scales, FPN, cross-view decoder, refiners) at small widths."""
    dino = DinoConfig(
        d_model=32,
        depth=2,
        num_heads=2,
        patch_size=14,
        pos_embed_size=8,
        decoder_cfg=DecoderConfig(num_cross_attn=1, nhead=2, train_avg_length=64),
    )
    enc = EncoderConfig(feat_chs=(16, 8, 8, 8))
    matcher = MatcherConfig(
        num_grid=(8, 8, 16, 32, 64),
        radius=(2, 2, 1, 1, 0),
        displacement_dim=(8, 8, 8, 8, 8),
        num_itr=(1, 1, 1, 1, 1),
    )
    return ModelConfig(
        dino=dino,
        encoder=enc,
        matcher=matcher,
        initial_res=(112, 112),
        upsample_res=(168, 168),
    )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (ref `train.py:60-119`)."""

    total_pairs: int = 2_000_000  # ref train.py:65
    ckpt_every_pairs: int = 25_000  # ref train.py:67
    per_host_batch_size: int = 8
    lr_per_sample: float = 1e-4 / 8  # lr = step_size * 1e-4/8, ref train.py:108
    weight_decay: float = 0.01
    grad_clip_norm: float = 0.01  # ref train.py:119
    ce_weight: float = 0.01
    alpha: float = 0.5
    c: float = 1e-4
    iteration_base: float = 1.0
    local_largest_scale: int = 8
    local_dist: dict | None = None  # {1:4, 2:4, 4:8, 8:8}, ref train.py:100

    def __post_init__(self):
        if self.local_dist is None:
            object.__setattr__(self, "local_dist", {1: 4, 2: 4, 4: 8, 8: 8})
