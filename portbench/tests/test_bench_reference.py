"""The plain reference against the port's CPU path at tiny width, float32.
(A test may import both; the reference itself imports nothing of the port.)"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import DATA, ROOT

from portbench import weights
from portbench.reference import keys as K
from portbench.reference.config import ModelConfig as ReferenceConfig
from portbench.reference.matcher import Reference


@pytest.fixture(scope="module")
def pair_of_matchers():
    import json

    from gfnet_tpu_torch.config import ModelConfig
    from gfnet_tpu_torch.matcher import GFNetMatcher

    raw = json.loads((DATA / "tiny.json").read_text())
    head, _ = weights.read_head(ROOT / raw["weights"]["head"], raw["weights"]["head_sha256"])
    dino = {k: raw["dino_cfg"][k] for k in ("d_model", "depth", "num_heads", "patch_size", "pos_embed_size",
                                            "mlp_ratio", "init_values")}
    vit = weights.draw_vit(dino)
    program = GFNetMatcher(ModelConfig.from_dict(raw), device="cpu", dtype=torch.float32, vit_state=vit,
                           head_state=head)
    return program, Reference(ReferenceConfig.from_dict(raw), vit, head, "cpu")


def test_weights_are_the_port_s():
    from gfnet_tpu_torch.config import tiny_test_config
    from gfnet_tpu_torch.utils.convert import jax_vit_state, load_head_npz

    cfg = tiny_test_config()
    dino = dataclasses.asdict(cfg.dino)
    dino.pop("decoder_cfg")
    drawn, theirs = weights.draw_vit(dino), jax_vit_state(cfg)
    assert drawn.keys() == theirs.keys()
    assert all(torch.equal(drawn[k], theirs[k]) for k in drawn)
    path = ROOT / "workspace" / "trained_head_tiny.npz"
    import hashlib

    head, flag = weights.read_head(path, hashlib.sha256(path.read_bytes()).hexdigest())
    ported, ported_flag = load_head_npz(str(path))
    assert bool(ported_flag) == flag and head.keys() == ported.keys()
    assert all(torch.equal(head[k], ported[k]) for k in head)
    with pytest.raises(ValueError, match="sha256"):
        weights.read_head(path, "0" * 64)


def test_keys_are_the_port_s():
    from gfnet_tpu_torch.utils import jax_init, jax_random

    for seed in (0, 2**31 + 5, 123456789012):
        key = K.prng_key(seed)
        assert np.array_equal(K.split(key, 5), jax_init.split(key, 5))
        assert np.array_equal(K.fold_in(key, 7), jax_init.fold_in(key, 7))
        ks = K.split(key, 3)
        assert torch.equal(K.draw_words(ks, [5, 300, 9], "cpu"), jax_random.draw_words(ks, [5, 300, 9], "cpu"))


def test_match_and_solve_equal_the_port_s(pair_of_matchers):
    program, ref = pair_of_matchers
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0, 1, (2, 112, 112, 3)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0, 1, (2, 112, 112, 3)).astype(np.float32))
    warp, cert = program.match(a, b)
    warp_r, cert_r = ref.match(a, b)
    assert (warp - warp_r).abs().max() < 1e-5 and (cert - cert_r).abs().max() < 1e-5
    keys = K.split(K.prng_key(11), 2)
    H = program.estimate_homography_batched(a, b, num_matches=300, pair_keys=keys)
    H_r = ref.sample_solve(warp, cert, 300, (112, 112), (112, 112), keys)
    assert torch.allclose(H, H_r, rtol=1e-5, atol=1e-5)
