"""The training slice as a whole: one train step of the port against the JAX
package's, tiny config, float32 on the CPU, with the JAX weights carried over
by `gfnet_tpu_torch.utils.convert` and the same seeded batch on both sides.

The JAX side is jit-compiled once per module (the tiny step's compile is the
expensive part), with `mesh=None`, `GFNET_S2D=0`, `GFNET_KV_NORM` cleared and
`GFNET_GRAD_BREAKDOWN=1`. Gradients are held against gradients and the
optimizer against optax on fed gradients (tests/test_torch_train_modules.py),
not parameters after several Adam steps: Adam's first update is ±lr whatever
the gradient's size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfnet_tpu.config import TrainConfig as JTrainConfig
from gfnet_tpu.config import tiny_test_config as jax_tiny_config
from gfnet_tpu.matcher.api import GFNetMatcher as JGFNetMatcher
from gfnet_tpu.train.loss import RobustLoss as JRobustLoss
from gfnet_tpu.train.state import create_train_state as j_create_train_state
from gfnet_tpu.train.step import make_train_step as j_make_train_step
from gfnet_tpu_torch.config import TrainConfig, tiny_test_config
from gfnet_tpu_torch.matcher import GFNetMatcher
from gfnet_tpu_torch.train.loss import RobustLoss
from gfnet_tpu_torch.train.state import create_train_state
from gfnet_tpu_torch.train.step import head_modules, make_train_step
from gfnet_tpu_torch.utils import convert

RES, BATCH = 112, 2
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def jitter(tree, seed: int):
    """Numpy copy of a flax variable tree with seeded noise on every leaf, so
    that no LayerScale, BatchNorm or bias is an identity."""
    rng = np.random.default_rng(seed)

    def go(t, name=""):
        if isinstance(t, dict) or hasattr(t, "items"):
            return {k: go(v, k) for k, v in t.items()}
        a = np.asarray(t, np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)

    return go(tree)


def make_batch(seed: int) -> dict:
    """uint8 images (smooth, so the views correlate) and near-identity homographies."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, RES), np.linspace(0, 1, RES), indexing="ij")
    ims = []
    for _ in range(2):
        img = np.zeros((BATCH, RES, RES, 3), np.float32)
        for _ in range(6):
            f, ph = rng.uniform(1, 8, (BATCH, 1, 1, 3)), rng.uniform(0, 6.28, (BATCH, 1, 1, 3))
            ang = rng.uniform(0, 3.14, (BATCH, 1, 1, 3))
            img += np.sin(6.28 * f * (np.cos(ang) * xx[None, ..., None] + np.sin(ang) * yy[None, ..., None]) + ph)
        ims.append(((img - img.min()) / (img.max() - img.min()) * 255).astype(np.uint8))
    H = np.tile(np.eye(3, dtype=np.float32), (BATCH, 1, 1))
    H[:, :2, :2] += rng.normal(0, 0.03, (BATCH, 2, 2))
    H[:, :2, 2] = rng.uniform(-6, 6, (BATCH, 2))
    return {"im_A": ims[0], "im_B": ims[1], "H_s2t": H.astype(np.float32)}


def normalized(batch: dict) -> dict:
    """The host-normalized float32 twin of a uint8 batch."""
    norm = lambda t: ((t.astype(np.float32) / 255.0 - MEAN) / STD).astype(np.float32)
    return {"im_A": norm(batch["im_A"]), "im_B": norm(batch["im_B"]), "H_s2t": batch["H_s2t"]}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX tiny matcher with jittered head weights, and on one seeded
    batch: the real train step's metrics and new running statistics, and the
    loss function's corresps and raw gradients."""
    mp = pytest.MonkeyPatch()
    mp.setenv("GFNET_S2D", "0")
    mp.setenv("GFNET_GRAD_BREAKDOWN", "1")
    mp.delenv("GFNET_KV_NORM", raising=False)
    try:
        cfg = jax_tiny_config()
        matcher = JGFNetMatcher(cfg, dtype=jnp.float32)
        head_vars = jitter(matcher.head_vars, 21)
        loss = JRobustLoss(im_size=RES)
        batch = normalized(make_batch(22))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def forward(params, batch_stats, vit_params, b):
            tokens = matcher.vit.apply(vit_params, jnp.concatenate([b["im_A"], b["im_B"]], axis=0))

            def loss_fn(p):
                corresps, mut = matcher.head.apply({"params": p, "batch_stats": batch_stats}, b["im_A"],
                                                   b["im_B"], tokens, symmetric=False, train=True,
                                                   mutable=["batch_stats"])
                total, _ = loss(corresps, b["H_s2t"], (RES, RES), (RES, RES))
                return total, (corresps, mut["batch_stats"])

            (total, (corresps, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            return tokens, total, corresps, new_bs, grads

        tokens, total, corresps, new_bs, grads = jax.jit(forward)(
            head_vars["params"], head_vars["batch_stats"], matcher.vit_params, jb)
        state = j_create_train_state(jax.tree_util.tree_map(jnp.array, head_vars), JTrainConfig(), BATCH)
        new_state, metrics = j_make_train_step(matcher, loss)(state, matcher.vit_params, jb)
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        yield {"vit_params": to_np(matcher.vit_params), "head_vars": head_vars, "tokens": np.asarray(tokens),
               "total": float(total), "corresps": to_np(corresps), "new_bs": to_np(new_bs),
               "grads": to_np(grads), "metrics": {k: float(v) for k, v in metrics.items()},
               "step_bs": to_np(new_state.batch_stats)}
    finally:
        mp.undo()


def port_matcher(jax_side) -> GFNetMatcher:
    """A fresh port matcher with the JAX side's weights."""
    return GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32,
                        vit_state=convert.flax_to_torch_vit(jax_side["vit_params"]),
                        head_state=convert.flax_to_torch_head(jax_side["head_vars"]))


def port_step(jax_side, batch, clip=TrainConfig().grad_clip_norm, **options):
    m = port_matcher(jax_side)
    state = create_train_state(m.head, TrainConfig(grad_clip_norm=clip), BATCH)
    before = {k: v.detach().clone() for k, v in m.head.state_dict().items()}
    state, metrics = make_train_step(m, RobustLoss(im_size=RES), **options)(state, batch)
    return m, before, {k: float(v) for k, v in metrics.items()}


def running_stats(state_dict: dict) -> dict:
    return {k: v for k, v in state_dict.items() if "running_" in k}


def test_head_training_forward_matches_jax(jax_side):
    """`head.train()` forward on the JAX tokens: every corresps entry and the
    running statistics after it, against `head.apply(..., train=True,
    mutable=["batch_stats"])`."""
    m = port_matcher(jax_side)
    batch = normalized(make_batch(22))
    m.head.train()
    got = m.head(T(batch["im_A"]), T(batch["im_B"]), T(jax_side["tokens"]), symmetric=False)
    want = jax_side["corresps"]
    assert sorted(got) == sorted(want)
    for s in want:
        for itr in want[s]:
            for key in ("flow", "certainty"):
                # float32 summation order through the stack, batch statistics included;
                # a sound run read at most 8.4e-5
                np.testing.assert_allclose(got[s][itr][key].detach().numpy(), want[s][itr][key],
                                           rtol=2e-4, atol=2e-4, err_msg=f"scale {s} {key}")
    want_stats = running_stats(convert.flax_to_torch_head(
        {"params": jax_side["head_vars"]["params"], "batch_stats": jax_side["new_bs"]}))
    got_stats = running_stats(m.head.state_dict())
    old_stats = running_stats(convert.flax_to_torch_head(jax_side["head_vars"]))
    assert sorted(got_stats) == sorted(want_stats) and len(want_stats) > 100
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
        assert not torch.equal(got_stats[k], old_stats[k]), k  # each one moved


def test_train_step_metrics_and_running_stats_match_jax(jax_side, monkeypatch):
    monkeypatch.setenv("GFNET_GRAD_BREAKDOWN", "1")
    m, _, got = port_step(jax_side, normalized(make_batch(22)))
    want = jax_side["metrics"]
    assert sorted(got) == sorted(want)
    assert got["nonfinite_grad_leaves"] == want["nonfinite_grad_leaves"] == 0
    for k, w in want.items():
        # losses and norms in float32; gradient norms carry the backward's
        # summation order through the refiners. A sound run read at most 5.5e-5 relative
        np.testing.assert_allclose(got[k], w, rtol=5e-4, atol=1e-6, err_msg=k)
    assert got["total_loss"] == pytest.approx(jax_side["total"], rel=1e-5)
    # the step recomputes the extractor and every refiner in backward, yet
    # moves the running statistics once, as the JAX step does
    want_stats = running_stats(convert.flax_to_torch_head(
        {"params": jax_side["head_vars"]["params"], "batch_stats": jax_side["step_bs"]}))
    for k, v in running_stats(m.head.state_dict()).items():
        np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    assert not m.head.training  # back in eval mode for the matcher


def test_train_step_gradients_match_jax(jax_side):
    """The gradient of every head leaf, JAX's carried through the weight
    bridge (which is linear in the parameters). The clip is out of reach, so
    `.grad` holds the raw gradients after the step."""
    m, _, _ = port_step(jax_side, normalized(make_batch(22)), clip=1e30)
    want = convert.flax_to_torch_head({"params": jax_side["grads"],
                                       "batch_stats": jax_side["head_vars"]["batch_stats"]})
    scale = {}  # the largest gradient entry of each top-level module
    prefix = {id(p): name for name, mod in head_modules(m.head).items() for p in mod.parameters()}
    for k, p in m.head.named_parameters():
        scale[prefix[id(p)]] = max(scale.get(prefix[id(p)], 0.0), float(want[k].abs().max()))
    assert all(v > 0 for v in scale.values())
    # a bias in front of a train-mode BatchNorm has a zero gradient, so a leaf
    # is held to its module's scale, not its own
    ratio = {k: float((p.grad - want[k]).abs().max()) / scale[prefix[id(p)]]
             for k, p in m.head.named_parameters()}
    assert len(ratio) == len(list(m.head.parameters())) > 300
    worst = max(ratio, key=ratio.get)
    print(f"worst gradient leaf {worst}: {ratio[worst]:.3g} of its module's largest entry")
    # float32 summation order through the recomputed refiners: a sound run
    # read 1.5e-3 (at conv_refiner.1.hidden_blocks.0.3.weight)
    assert ratio[worst] <= 5e-3, (worst, ratio[worst])


def test_uint8_batch_matches_host_normalized_twin(jax_side):
    raw = make_batch(23)
    _, _, m_u8 = port_step(jax_side, raw)
    _, _, m_f32 = port_step(jax_side, normalized(raw))
    assert m_u8["total_loss"] == pytest.approx(m_f32["total_loss"], rel=1e-5)
    assert m_u8["grad_norm"] == pytest.approx(m_f32["grad_norm"], rel=1e-3)


def _moved(m, before, name):
    mod = head_modules(m.head)[name]
    full = {id(p): k for k, p in m.head.named_parameters()}
    return max(float((p.detach() - before[full[id(p)]]).abs().max()) for p in mod.parameters())


def test_freeze_zeroes_module_gradients(jax_side, monkeypatch):
    monkeypatch.setenv("GFNET_GRAD_BREAKDOWN", "1")
    m, before, got = port_step(jax_side, normalized(make_batch(22)), freeze=("crossview",))
    raw = jax_side["metrics"]
    assert got["gnorm/crossview"] == 0.0
    assert got["gnorm_raw/crossview"] == pytest.approx(raw["gnorm_raw/crossview"], rel=5e-4)
    others = np.sqrt(sum(raw[k] ** 2 for k in raw if k.startswith("gnorm_raw/") and k != "gnorm_raw/crossview"))
    assert got["grad_norm"] == pytest.approx(others, rel=5e-4)
    # frozen up to AdamW's decoupled decay (lr * wd * |p| ~ 1e-6); the rest learns
    assert _moved(m, before, "crossview") < 1e-5
    assert _moved(m, before, "encoder") > 1e-5


def test_module_clip_caps_one_module_only(jax_side, monkeypatch):
    monkeypatch.setenv("GFNET_GRAD_BREAKDOWN", "1")
    raw = jax_side["metrics"]
    cap = raw["gnorm_raw/crossview"] / 50
    m, before, got = port_step(jax_side, normalized(make_batch(22)), module_clip={"crossview": cap})
    assert got["gnorm/crossview"] == pytest.approx(cap, rel=1e-4)
    assert got["gnorm/encoder"] == pytest.approx(raw["gnorm_raw/encoder"], rel=5e-4)
    assert _moved(m, before, "crossview") > 1e-5  # capped, not frozen


def test_module_spike_zero_rejects_above_threshold_only(jax_side, monkeypatch):
    monkeypatch.setenv("GFNET_GRAD_BREAKDOWN", "1")
    raw = jax_side["metrics"]
    _, _, got = port_step(jax_side, normalized(make_batch(22)),
                          module_spike_zero={"encoder": raw["gnorm_raw/encoder"] / 2,
                                             "crossview": raw["gnorm_raw/crossview"] * 2})
    assert got["gnorm/encoder"] == 0.0
    assert got["gnorm/crossview"] == pytest.approx(raw["gnorm_raw/crossview"], rel=5e-4)


@pytest.mark.parametrize("options", [dict(freeze=("cross_view",)), dict(module_clip={"refiner_16": 1.0}),
                                     dict(module_spike_zero={"fpn": 1.0})])
def test_unknown_module_name_raises(jax_side, options):
    with pytest.raises(ValueError, match="not in the head"):
        port_step(jax_side, normalized(make_batch(22)), **options)
