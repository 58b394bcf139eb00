"""DINOv2 with registers in the port (`models/vit.py`: register tokens, the
size-based antialiased pos-embed resample, the fused SwiGLU FFN) against
the benchmark's plain reference (`portbench/reference/vit_registers.py`),
in float32 on the CPU at a tiny width: the ViT on four grids, the
resample against `F.interpolate`, the matcher's batched homographies, and
the public checkpoint's key layout. The JAX package has no register ViT,
so nothing here is held against it.
"""

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from gfnet_tpu_torch.config import DecoderConfig, DinoConfig, tiny_test_config
from gfnet_tpu_torch.matcher import GFNetMatcher
from gfnet_tpu_torch.matcher.api import seeded_vit_state
from gfnet_tpu_torch.models.vit import SwiGLUFFNFused, VisionTransformer, interpolate_pos_encoding
from gfnet_tpu_torch.utils.convert import load_vit
from portbench.reference import keys as K
from portbench.reference.config import ModelConfig as ReferenceConfig
from portbench.reference.matcher_registers import RegisterReference
from portbench.reference.vit_registers import ViTConfig
from portbench.reference.vit_registers import VisionTransformer as ReferenceViT
from portbench.weights_vitreg import draw_vit

ROOT = Path(__file__).resolve().parents[1]
DINO = dict(d_model=48, depth=2, num_heads=3, patch_size=14, pos_embed_size=8, mlp_ratio=4.0, init_values=1.0,
            ffn_layer="swiglufused", num_register_tokens=4, interpolate_antialias=True, interpolate_offset=0.0)
GRIDS = {"native": (8, 8), "down": (6, 6), "up": (10, 10), "non_square": (6, 9)}


def register_config():
    """tiny_test_config's head on a 48-wide, 3-head ViT with 4 registers."""
    dino = DinoConfig(**DINO, decoder_cfg=DecoderConfig(num_cross_attn=1, nhead=2, train_avg_length=64))
    return tiny_test_config().replace(dino=dino, symmetric=True, upsample_preds=True, attenuate_cert=True)


def vit_state(seed: int = 0) -> dict:
    """DINOv2's draw (`portbench/weights_vitreg.py`), with the cls and
    register tokens, LayerScale and the norms drawn large enough to move the
    output: at DINOv2's std 1e-6 a token put in the wrong place would not."""
    sd = draw_vit(DINO, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    for k in sd:
        if k in ("cls_token", "register_tokens", "pos_embed") or k.endswith(("gamma", "norm1.weight", "norm.bias")):
            sd[k] = torch.randn(sd[k].shape, generator=gen) * 0.5 + (k.endswith("weight") or k.endswith("gamma"))
    return sd


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test suite runs several workers on the
    machine's cores, where torch's thread pool in each slows these CPU
    matcher calls about a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vits():
    sd = vit_state()
    port = VisionTransformer(register_config().dino, dtype=torch.float32)
    port.load_state_dict(sd)
    ref = ReferenceViT(ViTConfig.from_dict(DINO))
    ref.load_state_dict(sd)
    return port.eval(), ref.eval()


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_vit_matches_the_reference(vits, grid):
    port, ref = vits
    gh, gw = GRIDS[grid]
    x = torch.rand(2, 14 * gh, 14 * gw, 3, generator=torch.Generator().manual_seed(gh * 100 + gw))
    with torch.no_grad():
        out, want = port(x), ref(x)
    assert out.shape == (2, gh * gw, 48)
    assert (out - want).abs().max() < 1e-5


@pytest.mark.parametrize("size", [(37, 37), (32, 32), (40, 40), (32, 40), (40, 29)])
def test_pos_embed_resample_is_torch_s_antialiased_bicubic(size):
    gen = torch.Generator().manual_seed(size[0] * 100 + size[1])
    pos = torch.randn(1, 37 * 37 + 1, 8, generator=gen) * 0.02  # DINOv2's draw: std 0.02
    out = interpolate_pos_encoding(pos, *size, 37, offset=0.0, antialias=True)
    grid = pos[:, 1:].reshape(1, 37, 37, 8).permute(0, 3, 1, 2)
    want = F.interpolate(grid, size=size, mode="bicubic", antialias=True).permute(0, 2, 3, 1).reshape(1, -1, 8)
    assert torch.equal(out[:, :1], pos[:, :1])
    assert (out[:, 1:] - want).abs().max() < 1e-6


def test_the_resample_runs_in_float32_and_casts_back():
    pos = torch.randn(1, 37 * 37 + 1, 8, generator=torch.Generator().manual_seed(5)).to(torch.bfloat16)
    out = interpolate_pos_encoding(pos, 32, 32, 37, offset=0.0, antialias=True)
    want = interpolate_pos_encoding(pos.float(), 32, 32, 37, offset=0.0, antialias=True).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want)


def test_antialias_with_the_scale_based_resample_is_refused():
    with pytest.raises(ValueError, match="interpolate_offset 0"):
        DinoConfig(interpolate_antialias=True, interpolate_offset=0.1)
    assert DinoConfig(interpolate_antialias=True, interpolate_offset=0.0).interpolate_antialias


@pytest.fixture(scope="module")
def matchers():
    cfg = register_config()
    program = GFNetMatcher(cfg, device="cpu", dtype=torch.float32, vit_state=vit_state())
    raw = {"dino_cfg": {**DINO, "decoder_cfg": {"num_cross_attn": 1, "nhead": 2, "train_avg_length": 64}},
           "encoder_cfg": {"feat_chs": list(cfg.encoder.feat_chs)},
           "matcher": {k: list(getattr(cfg.matcher, k)) for k in ("num_grid", "radius", "displacement_dim", "num_itr")},
           "initial_res": list(cfg.initial_res), "upsample_res": list(cfg.upsample_res)}
    ref = RegisterReference(ReferenceConfig.from_dict(raw), ViTConfig.from_dict(raw["dino_cfg"]),
                            program.vit.state_dict(), program.head.state_dict(), "cpu")
    return program, ref


def test_batched_homographies_match_the_reference(matchers):
    program, ref = matchers
    gen = torch.Generator().manual_seed(7)
    a, b = torch.rand(2, 2, 100, 120, 3, generator=gen)
    warp, cert = program.match(a, b)
    warp_r, cert_r = ref.match(a, b)
    assert (warp - warp_r).abs().max() < 1e-5 and (cert - cert_r).abs().max() < 1e-5
    keys = K.split(K.prng_key(11), 2)
    H = program.estimate_homography_batched(a, b, num_matches=300, pair_keys=keys)
    H_r = ref.sample_solve(warp, cert, 300, (100, 120), (100, 120), keys)
    assert torch.isfinite(H).all() and torch.allclose(H, H_r, rtol=1e-5, atol=1e-5)


def test_a_seeded_matcher_draws_its_registers_as_dinov2():
    drawn = seeded_vit_state(register_config(), seed=3)  # what GFNetMatcher(cfg, seed=3) loads
    want = torch.randn((1, 4, 48), generator=torch.Generator().manual_seed(3)) * 1e-6
    assert torch.equal(drawn["register_tokens"], want)
    assert drawn.keys() == VisionTransformer(register_config().dino, dtype=torch.float32).state_dict().keys()


def test_the_public_key_layout_loads_strictly(tmp_path, matchers):
    program, ref = matchers
    sd = {k: v.clone() for k, v in program.vit.state_dict().items()}
    assert sd.keys() == ref.vit.state_dict().keys()
    assert {"register_tokens", "blocks.1.mlp.w12.weight", "blocks.1.mlp.w3.bias"} <= sd.keys()
    public = {**sd, "mask_token": torch.zeros(1, 48)}  # the layout of dinov2_vitg14_reg4_pretrain.pth
    torch.save(public, tmp_path / "dinov2_reg.pth")
    loaded = load_vit(str(tmp_path / "dinov2_reg.pth"))
    vit = VisionTransformer(register_config().dino, dtype=torch.float32)
    vit.load_state_dict(loaded)  # strict
    assert all(torch.equal(vit.state_dict()[k], sd[k]) for k in sd)
    with pytest.raises(RuntimeError, match="register_tokens"):
        VisionTransformer(tiny_test_config().dino, dtype=torch.float32).load_state_dict(loaded)



def test_the_benchmark_configuration_is_the_published_giant():
    raw = json.loads((ROOT / "portbench" / "configs" / "gfnet-vitg14-reg.json").read_text())
    from gfnet_tpu_torch.config import ModelConfig

    d = ModelConfig.from_dict(raw).dino
    assert (d.d_model, d.depth, d.num_heads, d.ffn_layer, d.num_register_tokens) == (1536, 40, 24, "swiglufused", 4)
    assert (d.interpolate_antialias, d.interpolate_offset, d.pos_embed_size) == (True, 0.0, 37)
    with torch.device("meta"):
        ffn = SwiGLUFFNFused(1536, 6144, torch.bfloat16)
    assert (ffn.hf, ffn.w12.weight.shape, ffn.w3.weight.shape) == (4096, (8192, 1536), (1536, 4096))
    assert ViTConfig.from_dict(raw["dino_cfg"]) == ViTConfig()
