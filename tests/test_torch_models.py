"""Each model module of the port against its JAX counterpart, with the JAX
weights carried over by `gfnet_tpu_torch.utils.convert`, float32 on the CPU.

Weights are the JAX init perturbed with seeded noise (BatchNorm variances
drawn positive), so no LayerScale, BatchNorm or bias is an identity.
Tolerances are float32 summation-order differences through the stack.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfnet_tpu.config import DecoderConfig as JDecoderConfig
from gfnet_tpu.config import tiny_test_config as jax_tiny_config
from gfnet_tpu.models.crossview import CrossViewDecoder as JCrossViewDecoder
from gfnet_tpu.models.fpn import FPNDecoder as JFPNDecoder
from gfnet_tpu.models.fpn import FPNEncoder as JFPNEncoder
from gfnet_tpu.models.gfnet import GFNet as JGFNet
from gfnet_tpu.models.refiner import ConvRefiner as JConvRefiner
from gfnet_tpu.models.vit import VisionTransformer as JVisionTransformer
from gfnet_tpu_torch.config import DecoderConfig, DinoConfig, tiny_test_config
from gfnet_tpu_torch.models.crossview import CrossViewDecoder
from gfnet_tpu_torch.models.fpn import FPNDecoder, FPNEncoder
from gfnet_tpu_torch.models.gfnet import GFNet
from gfnet_tpu_torch.models.refiner import ConvRefiner
from gfnet_tpu_torch.models.vit import VisionTransformer
from gfnet_tpu_torch.utils import convert

F32 = torch.float32


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def jitter(tree, seed: int):
    """Numpy copy of a flax variable tree with seeded noise on every leaf."""
    rng = np.random.default_rng(seed)

    def go(t, name=""):
        if isinstance(t, dict) or hasattr(t, "items"):
            return {k: go(v, k) for k, v in t.items()}
        a = np.asarray(t, np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)

    return go(tree)


def load(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    module.load_state_dict(sd, strict=True)
    return module.eval()


@pytest.mark.parametrize("depth,d,heads,ffn,hw", [
    (2, 32, 2, "mlp", (112, 98)),    # pos-embed resampled (8x7 grid from base 8)
    (2, 32, 2, "mlp", (112, 112)),   # native grid: pos-embed used as is
    (1, 48, 3, "swiglufused", (56, 70)),
])
def test_vit_matches_jax(depth, d, heads, ffn, hw):
    jcfg = dataclasses.replace(jax_tiny_config().dino, d_model=d, depth=depth, num_heads=heads,
                               ffn_layer=ffn)
    x = np.random.default_rng(0).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    jvit = JVisionTransformer(jcfg, dtype=jnp.float32)
    params = jitter(jax.jit(jvit.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = jax.jit(jvit.apply)(params, jnp.asarray(x))
    tcfg = DinoConfig(d_model=d, depth=depth, num_heads=heads, patch_size=14, pos_embed_size=8,
                      ffn_layer=ffn)
    vit = load(VisionTransformer(tcfg, dtype=F32), convert.flax_to_torch_vit(params))
    with torch.no_grad():
        got = vit(T(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use", ["norm", "add", "add_norm", "block"])
@pytest.mark.parametrize("d", [32, 48])
@pytest.mark.parametrize("dtype", [torch.bfloat16, F32])
def test_residual_stream_is_the_composition_of_layerscale_add_and_layernorm(dtype, d, use):
    """On the CPU `residual_norm` is `residual_norm_plain`, bit for bit the
    `LayerScale`, add and `LayerNorm` modules it replaced in the ViT, and a
    block returns what those modules gave it."""
    from gfnet_tpu_torch.models.common import LayerNorm, LayerScale
    from gfnet_tpu_torch.models.vit import Block
    from gfnet_tpu_torch.ops.residual_norm import residual_norm, residual_norm_plain

    gen = torch.Generator().manual_seed(d)
    x, h = (torch.randn((2, 5, d), generator=gen).to(dtype) for _ in range(2))
    if use == "block":
        blk = Block(d, 2, 4.0, 1.0, "swiglufused" if d == 48 else "mlp", dtype).to(dtype).eval()
        with torch.no_grad():
            for p in blk.parameters():
                p.normal_(0.0, 0.5, generator=gen)
            a = blk.attn(blk.norm1(x))
            x1 = x + blk.ls1(a)
            want = x1 + blk.ls2(blk.mlp(blk.norm2(x1)))
            assert torch.equal(blk(x), want)
        return
    norm, scale = LayerNorm(d, dtype=dtype), LayerScale(d, 0.5)
    with torch.no_grad():
        for p in (norm.weight, norm.bias, scale.gamma):
            p.normal_(1.0, 0.5, generator=gen)
        s = x if use == "norm" else x + scale(h)
        want = (s, None if use == "add" else norm(s))
        kw = dict(weight=norm.weight, bias=norm.bias, eps=norm.eps) if use != "add" else {}
        args = (x,) if use == "norm" else (x, h, scale.gamma)
        for fn in (residual_norm, residual_norm_plain):
            got = fn(*args, **kw)
            assert torch.equal(got[0], want[0]) and got[0].dtype == dtype
            assert (got[1] is None) if want[1] is None else (torch.equal(got[1], want[1]) and got[1].dtype == dtype)


@pytest.mark.parametrize("post_norm,pre_norm_query,kv_norm,ffn,attn", [
    (False, True, False, "ffn", "FLASH2"),
    (False, True, True, "ffn", "FLASH2"),
    (True, True, False, "ffn", "FLASH2"),
    (False, False, False, "glu", "FLASH2"),
    (False, True, False, "ffn", "Linear"),
])
def test_crossview_decoder_matches_jax(monkeypatch, post_norm, pre_norm_query, kv_norm, ffn, attn):
    if kv_norm:
        monkeypatch.setenv("GFNET_KV_NORM", "1")
    else:
        monkeypatch.delenv("GFNET_KV_NORM", raising=False)
    kw = dict(num_cross_attn=2, nhead=2, train_avg_length=64, post_norm=post_norm,
              pre_norm_query=pre_norm_query, ffn_type=ffn, attention_type=attn)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 48, 32)).astype(np.float32)
    y = rng.normal(0.5, 2, (2, 48, 32)).astype(np.float32)
    jdec = JCrossViewDecoder(d_vit=32, out_dim=16, cfg=JDecoderConfig(**kw), dtype=jnp.float32)
    params = jitter(jdec.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(y), (6, 8)), 4)
    wx, wy = jdec.apply(params, jnp.asarray(x), jnp.asarray(y), (6, 8))
    dec = load(CrossViewDecoder(32, 16, DecoderConfig(kv_norm=kv_norm, **kw), F32),
               convert.flax_to_torch_crossview(params["params"]))
    with torch.no_grad():
        gx, gy = dec(T(x), T(y), (6, 8))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-4, atol=1e-4)


def test_fpn_matches_jax():
    chs = (8, 8, 8, 16)
    x = np.random.default_rng(5).normal(0, 1, (2, 64, 48, 3)).astype(np.float32)
    jenc = JFPNEncoder(feat_chs=chs, dtype=jnp.float32)
    ev = jitter(jax.jit(jenc.init)(jax.random.PRNGKey(6), jnp.asarray(x)), 7)
    feats = jax.jit(jenc.apply)(ev, jnp.asarray(x))
    jdec = JFPNDecoder(feat_chs=chs, dtype=jnp.float32)
    dv = jitter(jax.jit(jdec.init)(jax.random.PRNGKey(8), *feats), 9)
    outs = jax.jit(jdec.apply)(dv, *feats)
    enc = load(FPNEncoder(chs, F32), convert.flax_to_torch_encoder(ev["params"], ev["batch_stats"]))
    dec = load(FPNDecoder(chs, F32), convert.flax_to_torch_fpn_decoder(dv["params"], dv["batch_stats"]))
    with torch.no_grad():
        tfeats = enc(T(x))
        touts = dec(*tfeats)
    for got, want in zip([*tfeats, *touts], [*feats, *outs]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("radius,g,scale_factor", [(2, 8, 1.0), (1, 12, 1.25), (0, 16, 1.25)])
def test_conv_refiner_matches_jax(monkeypatch, radius, g, scale_factor):
    monkeypatch.setenv("GFNET_S2D", "0")
    c, disp = 8, 8
    hidden = 2 * c + disp + ((2 * radius + 1) ** 2 if radius else 0)
    rng = np.random.default_rng(10)
    q = rng.normal(0, 1, (2, 14, 14, c)).astype(np.float32)
    t = rng.normal(0, 1, (2, 14, 14, c)).astype(np.float32)
    flow = rng.uniform(-1.05, 1.05, (2, g, g, 2)).astype(np.float32)
    jref = JConvRefiner(hidden_dim=hidden, displacement_dim=disp, radius=radius, dtype=jnp.float32)
    v = jitter(jax.jit(jref.init)(jax.random.PRNGKey(11), *map(jnp.asarray, (q, t, flow))), 12)
    wf, wc = jax.jit(lambda v_, *a: jref.apply(v_, *a, scale_factor=scale_factor))(
        v, *map(jnp.asarray, (q, t, flow)))
    ref = load(ConvRefiner(hidden, disp, radius, dtype=F32),
               convert.flax_to_torch_refiner(v["params"], v["batch_stats"]))
    with torch.no_grad():
        gf, gc = ref(T(q), T(t), T(flow), scale_factor=scale_factor)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def head_pair():
    """The tiny-config head in JAX and in the port with the same weights."""
    jcfg = jax_tiny_config()
    jhead = JGFNet(jcfg, dtype=jnp.float32)
    im = jnp.zeros((1, 112, 112, 3))
    v = jax.jit(lambda k: jhead.init(k, im, im, jnp.zeros((2, 64, 32))))(jax.random.PRNGKey(13))
    v = jitter(v, 14)
    head = load(GFNet(tiny_test_config(), dtype=F32), convert.flax_to_torch_head(v))
    return jhead, v, head


def _compare_corresps(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)  # jit returns the dict with sorted keys
    for s in want:
        for itr in want[s]:
            for key in ("flow", "certainty"):
                np.testing.assert_allclose(got[s][itr][key].numpy(), np.asarray(want[s][itr][key]),
                                           rtol=2e-4, atol=2e-4, err_msg=f"scale {s} {key}")


@pytest.mark.parametrize("symmetric", [False, True])
def test_gfnet_head_matches_jax(monkeypatch, head_pair, symmetric):
    monkeypatch.setenv("GFNET_S2D", "0")
    monkeypatch.delenv("GFNET_KV_NORM", raising=False)
    jhead, v, head = head_pair
    rng = np.random.default_rng(15)
    a, b = (rng.normal(0, 1, (1, 112, 112, 3)).astype(np.float32) for _ in range(2))
    tok = rng.normal(0, 1, (2, 64, 32)).astype(np.float32)
    fwd = jax.jit(lambda v_, a_, b_, t_: jhead.apply(v_, a_, b_, t_, symmetric=symmetric))
    want = fwd(v, jnp.asarray(a), jnp.asarray(b), jnp.asarray(tok))
    with torch.no_grad():
        got = head(T(a), T(b), T(tok), symmetric=symmetric)
    _compare_corresps(got, want)


def test_gfnet_head_upsample_pass_matches_jax(monkeypatch, head_pair):
    monkeypatch.setenv("GFNET_S2D", "0")
    monkeypatch.delenv("GFNET_KV_NORM", raising=False)
    jhead, v, head = head_pair
    rng = np.random.default_rng(16)
    a, b = (rng.normal(0, 1, (1, 168, 168, 3)).astype(np.float32) for _ in range(2))
    tok = rng.normal(0, 1, (2, 144, 32)).astype(np.float32)
    pre_flow = rng.uniform(-0.9, 0.9, (2, 64, 64, 2)).astype(np.float32)
    pre_cert = rng.normal(0, 1, (2, 64, 64, 1)).astype(np.float32)
    kw = dict(symmetric=True, upsample=True, scale_factor=1.5)
    grids = (12, 24, 48, 96)
    fwd = jax.jit(lambda v_, a_, b_, t_, f_, c_: jhead.apply(
        v_, a_, b_, t_, pre_flow=f_, pre_certainty=c_, num_grid_override=grids, **kw))
    want = fwd(v, *map(jnp.asarray, (a, b, tok, pre_flow, pre_cert)))
    with torch.no_grad():
        got = head(T(a), T(b), T(tok), pre_flow=T(pre_flow), pre_certainty=T(pre_cert),
                   num_grid_override=grids, **kw)
    _compare_corresps(got, want)
