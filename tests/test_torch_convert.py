"""The weight bridge, the `.npz` head loader, the config copy, import hygiene
and the no-GPU behaviour of the port's CUDA entry points."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfnet_tpu.config import ModelConfig as JModelConfig
from gfnet_tpu.config import tiny_test_config as jax_tiny_config
from gfnet_tpu.models.gfnet import GFNet as JGFNet
from gfnet_tpu.models.vit import VisionTransformer as JVisionTransformer
from gfnet_tpu.utils.convert import convert_dinov2_state_dict, convert_gfnet_head_state_dict
from gfnet_tpu_torch.config import ModelConfig, tiny_test_config
from gfnet_tpu_torch.matcher import GFNetMatcher
from gfnet_tpu_torch.models.gfnet import GFNet
from gfnet_tpu_torch.models.vit import VisionTransformer
from gfnet_tpu_torch.ops import kernels
from gfnet_tpu_torch.utils.convert import flax_to_torch_head, flax_to_torch_vit, load_head_npz
from torch_cpu import child_env, one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
HEADS = {"tiny": ("workspace/trained_head_tiny.npz", None),  # no flag in the file: None
         "flagship_r5b": ("workspace/trained_head_flagship_r5b.npz", True)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("ffn", ["mlp", "swiglufused"])
def test_vit_bridge_round_trips_through_convert_dinov2(ffn):
    import dataclasses

    cfg = dataclasses.replace(jax_tiny_config().dino, ffn_layer=ffn)
    params = jax.jit(JVisionTransformer(cfg, dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)))
    sd = flax_to_torch_vit(params)
    if ffn == "mlp":  # the reference DINOv2 converter knows the MLP FFN
        _assert_same_tree(convert_dinov2_state_dict(_numpy_sd(sd)), params["params"])
    from gfnet_tpu_torch.config import DinoConfig

    tcfg = DinoConfig(**{k: getattr(cfg, k) for k in ("d_model", "depth", "num_heads", "patch_size",
                                                      "pos_embed_size", "ffn_layer")})
    VisionTransformer(tcfg, dtype=torch.float32).load_state_dict(sd, strict=True)


def test_head_bridge_round_trips_through_convert_gfnet_head():
    head = JGFNet(jax_tiny_config(), dtype=jnp.float32)
    im = jnp.zeros((1, 112, 112, 3))
    v = jax.jit(lambda k: head.init(k, im, im, jnp.zeros((2, 64, 32))))(jax.random.PRNGKey(1))
    sd = flax_to_torch_head(v)
    _assert_same_tree(convert_gfnet_head_state_dict(_numpy_sd(sd)), v)
    GFNet(tiny_test_config(), dtype=torch.float32).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name", sorted(HEADS))
def test_load_head_npz_fills_every_parameter(monkeypatch, name):
    path, want_kv_norm = HEADS[name]
    monkeypatch.delenv("GFNET_KV_NORM", raising=False)
    env_before = dict(os.environ)
    sd, kv_norm = load_head_npz(str(REPO / path))
    assert dict(os.environ) == env_before  # unlike the JAX loader, no env side effect
    assert kv_norm is want_kv_norm
    cfg = tiny_test_config() if name == "tiny" else ModelConfig()
    result = GFNet(cfg, dtype=torch.float32).load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    with np.load(REPO / path) as raw:
        n_leaves = sum(np.asarray(raw[k]).size for k in raw.files if k != "__protocol_kv_norm__")
    assert sum(t.numel() for t in sd.values()) == n_leaves


def test_from_pretrained_on_cpu_with_config_json(tmp_path):
    cfg = tiny_test_config()
    conf = {"dino_cfg": {"d_model": cfg.dino.d_model, "depth": cfg.dino.depth,
                         "num_heads": cfg.dino.num_heads, "pos_embed_size": cfg.dino.pos_embed_size,
                         "decoder_cfg": {"num_cross_attn": 1, "nhead": 2, "train_avg_length": 64}},
            "encoder_cfg": {"feat_chs": list(cfg.encoder.feat_chs)},
            "matcher": {"num_grid": list(cfg.matcher.num_grid), "radius": list(cfg.matcher.radius),
                        "displacement_dim": list(cfg.matcher.displacement_dim)},
            "initial_res": list(cfg.initial_res), "upsample_res": list(cfg.upsample_res)}
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(conf))
    m = GFNetMatcher.from_pretrained(str(path), str(REPO / HEADS["tiny"][0]), device="cpu",
                                     dtype=torch.float32)
    assert m.cfg == cfg
    sd, _ = load_head_npz(str(REPO / HEADS["tiny"][0]))
    torch.testing.assert_close(m.head.state_dict()["conv_refiner.1.out_conv.weight"],
                               sd["conv_refiner.1.out_conv.weight"])


@pytest.mark.parametrize("path", ["gfnet_tpu/configs/basic.json", "gfnet_tpu/configs/map.json"])
def test_config_copy_reads_reference_json_like_jax(path):
    import dataclasses

    got = dataclasses.asdict(ModelConfig.from_json(REPO / path))
    want = dataclasses.asdict(JModelConfig.from_json(REPO / path))
    assert got["dino"]["decoder_cfg"].pop("kv_norm") is False
    # the register ViT's fields, which the JAX package lacks, keep its ViT at their defaults
    assert [got["dino"].pop(k) for k in ("num_register_tokens", "interpolate_antialias",
                                         "interpolate_offset")] == [0, False, 0.1]
    assert got == want
    assert tiny_test_config().with_kv_norm(False) == tiny_test_config()
    assert tiny_test_config().with_kv_norm(True).dino.decoder_cfg.kv_norm


@pytest.mark.parametrize("conf", [False, True])
@pytest.mark.parametrize("flag", [None, False, True])
def test_head_file_only_turns_kv_norm_on(conf, flag):
    """JAX's `GFNET_KV_NORM=1` OR the file's `__protocol_kv_norm__`: a head
    that says nothing (None) or False keeps the config's flag."""
    cfg = tiny_test_config().with_kv_norm(conf).with_head_kv_norm(flag)
    assert cfg.dino.decoder_cfg.kv_norm is (conf or flag is True)


def test_package_imports_neither_jax_nor_gfnet_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gfnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(gfnet_tpu_torch.__path__, 'gfnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'gfnet_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('gfnet_tpu_torch.')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=child_env(), capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_cuda_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GFNetMatcher(tiny_test_config())  # the default device is cuda
    with pytest.raises(ValueError, match="CUDA"):
        kernels.oneshot_attention(*(torch.zeros(1, 4, 1, 8),) * 3, 0.5)


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=child_env(), capture_output=True,
                             text=True, timeout=60)
        assert out.returncode != 0 and '"ok"' not in out.stdout
