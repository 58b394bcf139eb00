"""The work a call needs, counted from the configuration's shapes.

Every count here follows from the model's published shapes and the call's
batch, never from what the program happens to launch, so that the same call
counts the same work whoever implements it. A product of an m x k and a
k x n operand is 2·m·k·n operations; a convolution is such a product per
output pixel. Resizes, sampling and elementwise work are not counted.
Bytes count each input byte once and each output byte once.

Peaks: one NVIDIA H100 SXM at 700 W, NVIDIA's data sheet, dense rates.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
SCALES = ("16", "8", "4", "2", "1")
BF16, F32 = 2, 4


@dataclass(frozen=True)
class Attention:
    """One K1 call: `batch` sequences of `nq` queries over `nk` keys, in
    `heads` heads of `dim`, bf16 in and out."""

    batch: int
    nq: int
    nk: int
    heads: int
    dim: int

    @property
    def flops(self) -> float:
        return 4.0 * self.batch * self.heads * self.nq * self.nk * self.dim

    @property
    def bytes(self) -> float:
        return BF16 * self.batch * self.heads * self.dim * (2 * self.nq + 2 * self.nk)


@dataclass(frozen=True)
class LocalCorr:
    """One K2 call: `batch` query grids of `grid`² cells with `channels`
    channels against a `height` x `width` target, radius `radius`; bf16
    query and target, float32 flow and output. Its operations: each cell's
    (2r+2)² lattice dots and four products a tap to combine them."""

    batch: int
    grid: int
    height: int
    width: int
    channels: int
    radius: int

    @property
    def taps(self) -> int:
        return (2 * self.radius + 1) ** 2

    @property
    def flops(self) -> float:
        cells = self.batch * self.grid**2
        return cells * (2.0 * (2 * self.radius + 2) ** 2 * self.channels + 7.0 * self.taps)

    @property
    def bytes(self) -> float:
        cells = self.batch * self.grid**2
        return (BF16 * cells * self.channels + BF16 * self.batch * self.height * self.width * self.channels
                + F32 * cells * 2 + F32 * cells * self.taps)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def _dino(cfg: dict) -> dict:
    d = cfg["dino_cfg"]
    return {"d": d.get("d_model", 1024), "depth": d.get("depth", 24), "heads": d.get("num_heads", 16),
            "patch": d.get("patch_size", 14), "mlp": d.get("mlp_ratio", 4.0)}


def _passes(cfg: dict) -> list[tuple[int, list[str], list[int]]]:
    """(square resolution, scales, grids) of pass 1 and pass 2."""
    m, patch = cfg["matcher"], _dino(cfg)["patch"]
    r1, r2 = cfg["initial_res"][0], cfg["upsample_res"][0]
    g0 = r2 // patch
    return [(r1, list(SCALES), list(m["num_grid"])), (r2, list(SCALES[1:]), [g0, 2 * g0, 4 * g0, 8 * g0])]


def _feat(cfg: dict) -> dict:
    fd = cfg["encoder_cfg"]["feat_chs"]
    return {"16": fd[0], "8": fd[0], "4": fd[1], "2": fd[2], "1": fd[3]}


def _itr(cfg: dict, scale: str) -> int:
    return cfg["matcher"]["num_itr"][SCALES.index(scale)]


def _radius(cfg: dict, scale: str) -> int:
    return cfg["matcher"]["radius"][SCALES.index(scale)]


def _map_side(res: int, scale: str, patch: int) -> int:
    """The side of the feature map a scale's target lies on."""
    return res // patch if scale == "16" else res // int(scale)


def attention_calls(cfg: dict, pairs: int) -> list[Attention]:
    """Every attention of one call on `pairs` pairs: the ViT's blocks over
    both views, and the cross-view decoder's blocks over both directions."""
    v = _dino(cfg)
    dec = cfg["dino_cfg"]["decoder_cfg"]
    dim = cfg["encoder_cfg"]["feat_chs"][0]
    calls = []
    for res, _, _ in _passes(cfg):
        n = (res // v["patch"]) ** 2
        calls += [Attention(2 * pairs, n + 1, n + 1, v["heads"], v["d"] // v["heads"])] * v["depth"]
        calls += [Attention(2 * pairs, n, n, dec["nhead"], dim // dec["nhead"])] * dec["num_cross_attn"]
    return calls


def local_corr_calls(cfg: dict, pairs: int) -> list[LocalCorr]:
    """Every local correlation of one call: each refiner with a radius, in
    both directions (the symmetric batch), once per iteration."""
    patch, feat = _dino(cfg)["patch"], _feat(cfg)
    calls = []
    for res, scales, grids in _passes(cfg):
        for scale, g in zip(scales, grids):
            r = _radius(cfg, scale)
            if r > 0:
                side = _map_side(res, scale, patch)
                calls += [LocalCorr(2 * pairs, g, side, side, feat[scale], r)] * _itr(cfg, scale)
    return calls


def _conv(side: int, cin: int, cout: int, k: int, groups: int = 1) -> float:
    return 2.0 * side * side * (cin // groups) * cout * k * k


def _vit_flops(cfg: dict, res: int) -> float:
    v = _dino(cfg)
    d, n = v["d"], (res // v["patch"]) ** 2
    t, hidden = n + 1, int(d * v["mlp"])
    block = 2.0 * t * d * 3 * d + 4.0 * t * t * d + 2.0 * t * d * d + 2 * 2.0 * t * d * hidden
    return 2.0 * n * v["patch"] ** 2 * 3 * d + v["depth"] * block


def _decoder_flops(cfg: dict, res: int) -> float:
    v = _dino(cfg)
    dec = cfg["dino_cfg"]["decoder_cfg"]
    dim, n = cfg["encoder_cfg"]["feat_chs"][0], (res // v["patch"]) ** 2
    block = (4 * 2.0 * n * dim * dim + 4.0 * n * n * dim
             + 2 * 2.0 * n * dim * int(dim * dec.get("mlp_ratio", 4.0)))
    return 2.0 * n * v["d"] * dim + dec["num_cross_attn"] * block


def _fpn_flops(cfg: dict, res: int) -> float:
    c3, c2, c1, c0 = cfg["encoder_cfg"]["feat_chs"]  # coarse → fine
    s1, s2, s4, s8 = res, res // 2, res // 4, res // 8
    enc = (_conv(s1, 3, c0, 7) + _conv(s1, c0, c0, 5) + _conv(s2, c0, c1, 5) + 2 * _conv(s2, c1, c1, 3)
           + _conv(s4, c1, c2, 5) + 2 * _conv(s4, c2, c2, 3) + _conv(s8, c2, c3, 3) + 2 * _conv(s8, c3, c3, 3))
    merge = _conv(s8, 2 * c3, c3, 3)
    dec = (_conv(s8, c3, c3, 1) + _conv(s4, c3 + c2, c2, 3) + _conv(s4, c2, c2, 1) + _conv(s2, c2 + c1, c1, 3)
           + _conv(s2, c1, c1, 1) + _conv(s1, c1 + c0, c0, 3) + _conv(s1, c0, c0, 1))
    return enc + merge + dec


def _refiner_flops(cfg: dict, scale: str, g: int) -> float:
    """One refiner call on one row of the symmetric batch."""
    feat, i = _feat(cfg)[scale], SCALES.index(scale)
    r, disp = cfg["matcher"]["radius"][i], cfg["matcher"]["displacement_dim"][i]
    taps = (2 * r + 1) ** 2 if r > 0 else 0
    hid = 2 * feat + disp + taps
    blocks = 9 * (_conv(g, hid, hid, 5, groups=hid) + _conv(g, hid, hid, 1))
    corr = 2.0 * g * g * taps * feat
    return _conv(g, 2, disp, 1) + blocks + _conv(g, hid, 3, 1) + corr


def model_flops(cfg: dict, pairs: int, num_matches: int) -> float:
    """The products of one call on `pairs` pairs: the ViT on both views and
    the head in both directions at both passes, the global correlation, and
    the sampling's density estimate."""
    patch = _dino(cfg)["patch"]
    total = 0.0
    for res, scales, grids in _passes(cfg):
        total += 2 * pairs * (_vit_flops(cfg, res) + _decoder_flops(cfg, res) + _fpn_flops(cfg, res))
        for scale, g in zip(scales, grids):
            total += 2 * pairs * _itr(cfg, scale) * _refiner_flops(cfg, scale, g)
    n = (cfg["initial_res"][0] // patch) ** 2
    total += 2 * pairs * (2.0 * n * n * cfg["encoder_cfg"]["feat_chs"][0] + 2.0 * n * n * 2)
    g_final = _passes(cfg)[1][2][-1]
    n_good = min(4 * num_matches, 2 * g_final * g_final)
    total += pairs * 2.0 * n_good * n_good * 2
    return total
