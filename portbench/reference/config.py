"""The model's configuration as the reference reads it: the GFNet
experiment JSON's schema (`dino_cfg`, `encoder_cfg`, `matcher`) and the
resolutions, with the defaults of the published `basic.json`.
"""
from __future__ import annotations

import dataclasses
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
    # standardize the un-normalized k/v stream (pre_norm_query only)
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
    decoder_cfg: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)


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
    def from_dict(raw: dict) -> "ModelConfig":
        """The configuration of an experiment JSON (`basic.json`'s schema)."""
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
        return ModelConfig(dino=dino, encoder=enc, matcher=matcher, **extra)
