"""The port's training modules, each against its JAX counterpart on the CPU
in float32: BatchNorm in train mode, the robust loss, the optimizer and its
schedule, the checkpointer, the copied host-side modules and the training
CLI. Inputs come from numpy seeds and go to both sides.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gfnet_tpu.config import TrainConfig as JTrainConfig
from gfnet_tpu.data.homography_synth import random_homography_pair as j_random_homography_pair
from gfnet_tpu.eval import synthetic as j_synthetic
from gfnet_tpu.models.refiner import PhaseBN
from gfnet_tpu.train.loss import RobustLoss as JRobustLoss
from gfnet_tpu.train.loss import gt_warp_from_homography as j_gt_warp
from gfnet_tpu.train.state import make_lr_schedule as j_make_lr_schedule
from gfnet_tpu.train.state import make_optimizer as j_make_optimizer
from gfnet_tpu.utils.logging import MetricLogger as JMetricLogger
from gfnet_tpu_torch.cli import train as cli_train
from gfnet_tpu_torch.config import TrainConfig, tiny_test_config
from gfnet_tpu_torch.data.homography_synth import random_homography_pair_cv2
from gfnet_tpu_torch.eval import synthetic
from gfnet_tpu_torch.models.common import BatchNorm
from gfnet_tpu_torch.models.gfnet import GFNet
from gfnet_tpu_torch.train.checkpoint import Checkpointer
from gfnet_tpu_torch.train.loss import RobustLoss, gt_warp_from_homography
from gfnet_tpu_torch.train.state import TrainState, create_train_state, make_lr_schedule
from gfnet_tpu_torch.utils.convert import jax_head_state
from gfnet_tpu_torch.utils.logging import MetricLogger


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("flax_momentum", [0.99, 0.9])  # the refiners', the FPN's
def test_batchnorm_train_mode_matches_phasebn(flax_momentum):
    rng = np.random.default_rng(0)
    c = 6
    x = rng.normal(0.3, 2.0, (3, 5, 7, c)).astype(np.float32)
    scale, bias, mean, var = (rng.normal(1, 0.2, c), rng.normal(0, 0.2, c), rng.normal(0, 1, c),
                              rng.uniform(0.5, 1.5, c))
    variables = {"params": {"scale": jnp.asarray(scale, jnp.float32), "bias": jnp.asarray(bias, jnp.float32)},
                 "batch_stats": {"mean": jnp.asarray(mean, jnp.float32), "var": jnp.asarray(var, jnp.float32)}}
    jbn = PhaseBN(c, momentum=flax_momentum)
    want, mut = jbn.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    bn = BatchNorm(c, momentum=1 - flax_momentum).train()
    bn.load_state_dict({"weight": T(scale), "bias": T(bias), "running_mean": T(mean), "running_var": T(var)})
    got = bn(T(x))
    # float32 moments over 105 values in another order; a sound run read at most 9.5e-7
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
    # the biased batch variance goes into the running one (F.batch_norm's is unbiased:
    # with 105 values it would read 1e-3 off here at momentum 0.1)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), rtol=1e-6, atol=1e-6)
    # eval mode afterwards normalizes with the new running statistics
    want_eval = jbn.apply({"params": variables["params"], "batch_stats": mut["batch_stats"]}, jnp.asarray(x), False)
    np.testing.assert_allclose(bn.eval()(T(x)).detach().numpy(), np.asarray(want_eval), rtol=1e-5, atol=1e-5)


def test_batchnorm_frozen_running_stats_under_recompute():
    """A forward repeated by `checkpoint_module` in backward must not move
    the running statistics a second time."""
    from gfnet_tpu_torch.models.common import checkpoint_module

    bn = BatchNorm(4, momentum=0.1).train()
    x = torch.randn(2, 3, 3, 4, requires_grad=True)
    checkpoint_module(bn, bn, x).sum().backward()
    once = BatchNorm(4, momentum=0.1).train()
    once(x.detach())
    torch.testing.assert_close(bn.running_mean, once.running_mean, rtol=0, atol=0)
    torch.testing.assert_close(bn.running_var, once.running_var, rtol=0, atol=0)
    assert bn.update_running


# --------------------------------------------------------------------- loss
def _corresps(rng, b, grids, n_itr):
    out = {}
    for scale, g in grids.items():
        out[scale] = {itr: {"flow": rng.uniform(-1, 1, (b, g, g, 2)).astype(np.float32),
                            "certainty": rng.normal(0, 2, (b, g, g, 1)).astype(np.float32)}
                      for itr in range(1, n_itr + 1)}
    return out


def _homographies(rng, b):
    H = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    H[:, :2, :2] += rng.normal(0, 0.05, (b, 2, 2))
    H[:, :2, 2] = rng.uniform(-12, 12, (b, 2))
    H[:, 2, :2] = rng.normal(0, 2e-4, (b, 2))
    return H.astype(np.float32)


def test_gt_warp_matches_jax():
    H = _homographies(np.random.default_rng(1), 3)
    want_x, want_p = j_gt_warp(jnp.asarray(H), (112, 112), (112, 112), (16, 16))
    got_x, got_p = gt_warp_from_homography(T(H), (112, 112), (112, 112), (16, 16))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert 0 < got_p.mean() < 1  # some cells leave the target


@pytest.mark.parametrize("iteration_base", [0.85, 1.0])
def test_robust_loss_matches_jax(iteration_base):
    rng = np.random.default_rng(2)
    b = 3
    grids = {"16": 8, "8": 8, "4": 16, "2": 32, "1": 64}
    corresps = _corresps(rng, b, grids, n_itr=2)
    # close to the truth at the coarse scales, so the fine-scale gate keeps some cells
    H = _homographies(rng, b)
    for scale in ("16", "8", "4"):
        g = grids[scale]
        x2, _ = j_gt_warp(jnp.asarray(H), (112, 112), (112, 112), (g, g))
        for itr in corresps[scale]:
            corresps[scale][itr]["flow"] = (np.asarray(x2) + rng.normal(0, 0.02, (b, g, g, 2))).astype(np.float32)
    kw = dict(iteration_base=iteration_base, im_size=112)
    # dict comprehensions keep the coarse-to-fine order (jax.tree_util would sort the keys)
    jc = {s: {i: {k: jnp.asarray(v) for k, v in d.items()} for i, d in it.items()} for s, it in corresps.items()}
    tc = {s: {i: {k: T(v) for k, v in d.items()} for i, d in it.items()} for s, it in corresps.items()}
    want_l, want_m = JRobustLoss(**kw)(jc, jnp.asarray(H), (112, 112), (112, 112))
    got_l, got_m = RobustLoss(**kw)(tc, T(H), (112, 112), (112, 112))
    assert sorted(got_m) == sorted(want_m)
    # float32 means over up to 3·64² cells; a sound run read at most 3.7e-7 relative
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(got_m["train_pck_05_scale_4"]) > 0  # the gate did not empty the supervision


# ---------------------------------------------------------------- optimizer
def test_lr_schedule_matches_jax():
    cfg = dict(total_pairs=100_000, ckpt_every_pairs=10_000)
    want, got = j_make_lr_schedule(JTrainConfig(**cfg), 10), make_lr_schedule(TrainConfig(**cfg), 10)
    for step in (0, 999, 1000, 4321, 9999, 10_000, 12_345):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12)
    assert got(0) == pytest.approx(TrainConfig().lr_per_sample * 10)


def test_train_config_matches_jax():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())


def test_optimizer_matches_optax_across_a_chunk_boundary():
    """Clip + AdamW + per-chunk cosine schedule against
    `optax.chain(clip_by_global_norm, adamw(schedule))` on the same seeded
    gradients, 5 steps with the schedule stepping after the third. Gradient
    norms straddle the clip (0.01), where `clip_grad_norm_`'s 1e-6 would
    read 1e-4 off."""
    rng = np.random.default_rng(3)
    cfg = dict(total_pairs=48, ckpt_every_pairs=24, grad_clip_norm=0.01)  # k = 3 steps, 2 epochs
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, 1, s) * scale).astype(np.float32) for k, s in shapes.items()}
             for scale in (1e-3, 3e-3, 1.0, 2e-3, 1e-4)]

    tx = j_make_optimizer(JTrainConfig(**cfg), 8)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    head = torch.nn.ParameterDict({k: torch.nn.Parameter(T(v)) for k, v in params.items()})
    state = create_train_state(head, TrainConfig(**cfg), 8)
    rates = []
    for g in grads:
        for k, p in head.items():
            p.grad = T(g[k])
        state.apply_gradients()
        rates.append(state.optimizer.param_groups[0]["lr"])
    assert state.step == 5
    assert rates[0] == rates[2] > rates[3] == rates[4] > 0  # the schedule stepped once
    for k in params:
        np.testing.assert_allclose(head[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        # and the parameters did move by more than the tolerance
        assert np.abs(head[k].detach().numpy() - params[k]).max() > 1e-4


# ------------------------------------------------------------- checkpointer
def _tiny_state(seed: int) -> TrainState:
    head = GFNet(tiny_test_config(), dtype=torch.float32)
    head.load_state_dict(jax_head_state(tiny_test_config(), seed))
    return create_train_state(head, TrainConfig(), 8)


def _fake_step(state: TrainState, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    for p in state.head.parameters():
        p.grad = torch.randn(p.shape, generator=gen) * 1e-3
    state.apply_gradients()
    for b in state.head.buffers():
        b.add_(torch.rand(b.shape, generator=gen))


def test_checkpoint_roundtrip(tmp_path):
    state = _tiny_state(0)
    _fake_step(state, 1)
    ck = Checkpointer(str(tmp_path), "exp")
    ck.save(state)
    restored = ck.restore(_tiny_state(5))
    assert restored is not None and restored.step == state.step == 1
    want, got = state.head.state_dict(), restored.head.state_dict()
    assert any("running_mean" in k for k in want)
    for k in want:  # parameters and running statistics
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    for a, b in zip(state.optimizer.state_dict()["state"].values(),
                    restored.optimizer.state_dict()["state"].values()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(b[key], a[key], rtol=0, atol=0)
    # the restored state goes on training exactly as the saved one
    _fake_step(state, 2)
    _fake_step(restored, 2)
    for a, b in zip(state.head.parameters(), restored.head.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    # fresh directory (no file) -> None
    assert Checkpointer(str(tmp_path), "other").restore(_tiny_state(5)) is None


def test_checkpoint_crash_during_save_leaves_restorable(tmp_path):
    state = _tiny_state(0)
    ck = Checkpointer(str(tmp_path), "exp", keep=2)
    ck.save(state)
    first = ck.latest_path
    assert first is not None and first.endswith("step_000000000.pt")
    # a save of the next version that died mid-write: saves are written under
    # a temporary name and renamed, so the partial file looks like this
    with open(os.path.join(ck.dir, "step_000000100.pt.tmp-123"), "w") as f:
        f.write("partial")
    assert ck.latest_path == first
    restored = ck.restore(_tiny_state(5))
    assert restored is not None and restored.step == 0


def test_checkpoint_retention_prunes_oldest_only(tmp_path):
    state = _tiny_state(0)
    ck = Checkpointer(str(tmp_path), "exp", keep=2)
    for step in (0, 1, 2):
        state.step = step
        ck.save(state)
    names = sorted(d for d in os.listdir(ck.dir) if d.startswith("step_") and "tmp" not in d)
    assert names == ["step_000000001.pt", "step_000000002.pt"]
    assert ck.restore(_tiny_state(5)).step == 2


# ------------------------------------------------------- copied host modules
def test_train_batch_matches_jax_package():
    for kw in (dict(uint8=True), dict(cross_modal_frac=0.5)):
        want = j_synthetic.train_batch(np.random.default_rng(4), 2, 64, **kw)
        got = synthetic.train_batch(np.random.default_rng(4), 2, 64, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_random_homography_pair_matches_jax_package():
    rng = np.random.default_rng(5)
    tex = rng.uniform(0, 1, (150, 160, 3)).astype(np.float32)
    kw = dict(crop_size=100, input_hw=(64, 64), deformation_ratio=0.2, bi=True)
    want = j_random_homography_pair(tex, tex, rng=np.random.default_rng(6), **kw)
    got = random_homography_pair_cv2(tex, tex, rng=np.random.default_rng(6), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_metric_logger_lines_match_jax_package(tmp_path, capsys):
    metrics = {"total_loss": 1.25, "grad_norm": 0.5, "param_norm": 61.0, "lr": 1e-4, "extra": 3.0}
    lines = []
    for cls, name in ((JMetricLogger, "j.jsonl"), (MetricLogger, "t.jsonl")):
        path = tmp_path / name
        cls(use_wandb=False, jsonl_path=str(path)).log(metrics, step=16)
        rec = json.loads(path.read_text())
        rec.pop("time")
        lines.append((rec, capsys.readouterr().out))
    assert lines[0] == lines[1]
    assert lines[1][1].startswith("step 16: total_loss=1.25")


# ---------------------------------------------------------------------- CLI
def _uint8_stream(seed: int, b: int, res: int):
    rng = np.random.default_rng(seed)
    while True:
        yield {"im_A": rng.integers(0, 256, (b, res, res, 3), dtype=np.uint8),
               "im_B": rng.integers(0, 256, (b, res, res, 3), dtype=np.uint8),
               "H_s2t": _homographies(rng, b)}


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--tiny", "--device", "cpu", "--dataset", "synth", "--workspace", str(tmp_path),
            "--gpu_batch_size", "2", "--ckpt_every", "4", "--log_every", "1",
            "--dinov2_weights", str(tmp_path / "absent.npz")]
    state = cli_train.main(args + ["--total_pairs", "6"], batches=_uint8_stream(7, 2, 112))
    assert state.step == 3
    out = capsys.readouterr().out
    assert "checkpointed at step 2 (4 pairs)" in out and "training complete" in out
    assert sorted(os.listdir(tmp_path / "synth")) == ["step_000000002.pt", "step_000000003.pt"]
    logged = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged] == [2, 4, 6]
    assert all(np.isfinite(r["total_loss"]) and r["nonfinite_grad_leaves"] == 0 for r in logged)
    # a second call resumes from that step and runs the two steps that are left
    state = cli_train.main(args + ["--total_pairs", "10"], batches=_uint8_stream(8, 2, 112))
    assert "auto-resumed from step 3" in capsys.readouterr().out
    assert state.step == 5
    assert sorted(os.listdir(tmp_path / "synth")) == ["step_000000003.pt", "step_000000005.pt"]


def test_cli_says_that_eval_after_is_not_ported(tmp_path, capsys):
    """`--eval_after` is ported; where the dataset has no val set it says so
    and skips the benchmark, as the JAX package's trainer does."""
    args = ["--tiny", "--device", "cpu", "--dataset", "synth", "--workspace", str(tmp_path),
            "--gpu_batch_size", "2", "--total_pairs", "0", "--eval_after",
            "--dinov2_weights", str(tmp_path / "absent.npz")]
    cli_train.main(args, batches=iter(()))
    assert "eval_after skipped: val data unavailable" in capsys.readouterr().out


def test_cli_asking_for_cuda_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        cli_train.main(["--tiny", "--dataset", "synth", "--workspace", str(tmp_path),
                        "--dinov2_weights", str(tmp_path / "absent.npz")], batches=iter(()))


@pytest.mark.parametrize("kw", [dict(uint8=True, cross_modal_frac=0.5), dict(cross_modal_frac=0.0)],
                         ids=["uint8_cross_modal", "float"])
def test_train_batch_on_a_device_matches_the_cv2_stream(kw):
    """The tensor-op stream (`device=`) against the `cv2` one from the same
    generator, with `eval_pairs`' rule: homographies within float32 rounding
    (2e-6 relative), uint8 images at most 1 level off on under 0.1% of the
    pixels (a sound run: 1 level on 0.012%); float images within 1e-4 of a
    unit range (a sound run read 5.9e-6), the bulk within 1e-6."""
    want = synthetic.train_batch(np.random.default_rng(11), 3, 112, **kw)
    got = synthetic.train_batch(np.random.default_rng(11), 3, 112, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert tuple(got[k].shape) == want[k].shape, k
    Hw = want["H_s2t"]
    np.testing.assert_allclose(got["H_s2t"].numpy(), Hw, rtol=2e-6, atol=1e-6 * np.abs(Hw).max())
    for k in ("im_A", "im_B"):
        g, w = got[k].numpy(), want[k]
        if kw.get("uint8"):
            diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (k, diff.max(), (diff > 0).mean())
        else:
            diff = np.abs(g - w) * synthetic.IMAGENET_STD  # back to the [0, 1] range
            assert diff.max() <= 1e-4 and np.median(diff) <= 1e-6, (k, diff.max())
