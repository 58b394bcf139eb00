"""The port's evaluation path against the JAX package's, on the CPU.

`auc`, `corner_error_np` and `HomographyBenchmark.run` (serial, and batched
with a ragged tail) against `gfnet_tpu/eval/benchmark.py`; the tensor-op
`eval_pairs` against the `cv2` one of `gfnet_tpu/eval/synthetic.py`; and the
entry points (`benchmark_mace`, `demo_estimation`, `cli/test.py`,
`cli/train.py --eval_after`, `.pth` loading) at `tiny_test_config()` on a
val directory written by `tools/make_synth_valdir.py`.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from gfnet_tpu.eval import benchmark as jbench  # noqa: E402
from gfnet_tpu.eval.synthetic import eval_pairs as jax_eval_pairs  # noqa: E402
from gfnet_tpu_torch.cli import test as cli_test  # noqa: E402
from gfnet_tpu_torch.cli import train as cli_train  # noqa: E402
from gfnet_tpu_torch.config import tiny_test_config  # noqa: E402
from gfnet_tpu_torch.eval import benchmark as tbench  # noqa: E402
from gfnet_tpu_torch.eval.demo import demo_estimation  # noqa: E402
from gfnet_tpu_torch.eval.synthetic import benchmark_mace, eval_pairs  # noqa: E402
from gfnet_tpu_torch.matcher import GFNetMatcher  # noqa: E402
from gfnet_tpu_torch.models.gfnet import GFNet  # noqa: E402
from gfnet_tpu_torch.models.vit import VisionTransformer  # noqa: E402
from gfnet_tpu_torch.utils.convert import jax_head_state, load_head_npz  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_HEAD = os.path.join(REPO, "workspace", "trained_head_tiny.npz")
RUNTIME_KEYS = ("runtime_",)


# ------------------------------------------------------------ metric helpers
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auc_and_corner_error_equal_jax(seed):
    rng = np.random.default_rng(seed)
    errors = np.concatenate([rng.exponential(4.0, 40), [0.0, 3.0, 70.0]])
    thresholds = (3, 5, 10, 20)
    assert tbench.auc(errors, thresholds) == jbench.auc(errors, thresholds)
    for _ in range(5):
        H_gt = np.eye(3) + rng.normal(0, [[0.05, 0.05, 5], [0.05, 0.05, 5], [1e-4, 1e-4, 0]])
        H_pred = H_gt + rng.normal(0, 1e-3 * 10 ** rng.uniform(0, 3), (3, 3))
        assert (tbench.corner_error_np(H_pred, H_gt, 448, 320)
                == jbench.corner_error_np(H_pred, H_gt, 448, 320))


class _Named(list):
    def __init__(self, name, items):
        super().__init__(items)
        self.dataset = name


def _stub_homography(a) -> np.ndarray:
    """A homography made from an image's content, the same in both packages;
    an all-dark image gives a non-finite one (scored as degenerate)."""
    m = float(np.asarray(a, np.float64).mean())
    if m < 0.05:
        return np.full((3, 3), np.nan)
    return np.array([[1 + m / 50, m / 80, 40 * m], [-m / 90, 1, -30 * m], [m * 1e-4, 0, 1]])


class _StubJax:
    def estimate_homography(self, a, b, num_matches=5000, key=None):
        return _stub_homography(a)

    def estimate_homography_batched(self, a, b, key=None):
        return np.stack([_stub_homography(x) for x in a])


class _StubTorch:
    device = torch.device("cpu")

    def estimate_homography(self, a, b, num_matches=5000, key=None):
        assert a.dtype == torch.float32 and float(a.max()) <= 1.0
        return torch.from_numpy(_stub_homography(a.numpy()))

    def estimate_homography_batched(self, a, b, key=None, pair_keys=None):
        return torch.from_numpy(np.stack([_stub_homography(x) for x in a.numpy()]))


@pytest.mark.parametrize("batch_size", [None, 2, 4], ids=["serial", "batched2", "batched4"])
def test_benchmark_run_equals_jax_with_the_same_homographies(batch_size):
    rng = np.random.default_rng(3)
    pairs = []
    for i in range(5):  # batches of 2 and 4 leave a ragged tail
        a = rng.uniform(0, 0.02 if i == 2 else 1, (24, 32, 3)).astype(np.float32)
        H = np.eye(3) + rng.normal(0, [[0.02, 0.02, 3], [0.02, 0.02, 3], [1e-4, 1e-4, 0]])
        pairs.append({"im_A": a, "im_B": a[::-1].copy(), "H_s2t": H.astype(np.float32)})
    want = jbench.HomographyBenchmark(_Named("stubset", pairs)).run(_StubJax(), batch_size=batch_size)
    bench = tbench.HomographyBenchmark(_Named("stubset", pairs))
    got = bench.run(_StubTorch(), batch_size=batch_size)
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if not k.startswith(RUNTIME_KEYS)} == \
        {k: v for k, v in want.items() if not k.startswith(RUNTIME_KEYS)}
    degenerate = tbench.corner_error_np(np.diag([0.0, 0.0, 1.0]),
                                        pairs[2]["H_s2t"].astype(np.float64), 32, 24)
    assert len(bench.errors) == 5 and bench.errors[2] == degenerate
    assert got["mace_stubset"] == float(np.mean(bench.errors))


def test_uint8_images_are_read_as_the_val_dataset_reads_pngs():
    a = np.arange(256, dtype=np.uint8).reshape(16, 16, 1).repeat(3, -1)
    np.testing.assert_array_equal(tbench.unit_image(a).numpy(), a.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(tbench.unit_image(a / 255.0).numpy(), (a / 255.0).astype(np.float32))


# -------------------------------------------------------------- eval pairs
@pytest.mark.parametrize("cross_modal,deformation", [(False, 0.3), (True, 0.3), (False, 0.4)],
                         ids=["same_modal", "cross_modal", "texture_resized"])
def test_eval_pairs_equal_jax_package(cross_modal, deformation):
    """Same numpy draws, so the same homographies to float32 rounding; the
    images differ by interpolation rounding: at most 1 uint8 level, on under
    0.1% of the pixels. At deformation 0.4 the crop outgrows the texture,
    which is resized first."""
    n, res = 4, 112
    want = jax_eval_pairs(n, res, deformation, seed=1234, cross_modal=cross_modal)
    got = eval_pairs(n, res, deformation, seed=1234, cross_modal=cross_modal, device="cpu")
    assert got.dataset == ("synthetic_crossmodal" if cross_modal else "synthetic")
    to_u8 = lambda x: (np.clip(x, 0, 1) * 255).round().astype(np.uint8)  # tools/make_synth_valdir.py
    for w, g in zip(want, got):
        Hw = np.asarray(w["H_s2t"])
        assert g["H_s2t"].dtype == np.float32 and g["H_s2t"].shape == (3, 3)
        np.testing.assert_allclose(g["H_s2t"], Hw, rtol=2e-6, atol=1e-6 * np.abs(Hw).max())
        for k in ("im_A", "im_B"):
            assert g[k].dtype == torch.uint8 and tuple(g[k].shape) == (res, res, 3)
            diff = np.abs(g[k].numpy().astype(int) - to_u8(w[k]).astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (k, diff.max(), (diff > 0).mean())


def test_eval_pairs_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_pairs(1, 112, 0.3)


# ------------------------------------------------------------ entry points
@pytest.fixture(scope="module")
def valdir(tmp_path_factory):
    """Three 112² same-modal pairs in the reference's val layout."""
    root = tmp_path_factory.mktemp("data")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import make_synth_valdir
    finally:
        sys.path.pop(0)
    make_synth_valdir.main(["--n", "3", "--res", "112", "--deformation", "0.3", "--out", str(root)])
    return root


@pytest.fixture(scope="module")
def tiny_matcher():
    head, kv_norm = load_head_npz(TINY_HEAD)
    return GFNetMatcher(tiny_test_config().with_kv_norm(kv_norm), device="cpu",
                        dtype=torch.float32, head_state=head)


# The port's own `eval_pairs` differ from the JAX package's (rounded to
# uint8) by one level on a few pixels. That keeps the candidates of the
# certainty draw but reorders them, and the balanced draw and RANSAC address
# positions, so a pair is in effect drawn anew: on a pair the tiny head does
# not register, ACE then lands anywhere in its spread over keys (pair 0 here:
# 33-70 px over 8 keys, 47.5 against 26.4 px across the two pair sets). On a
# pair both register within 5 px (AUC@5's threshold) the two readings lie
# inside that pair's spread over 8 keys (pair 1: 2.60-3.33 and 2.44-3.50 px);
# a sound run reads 2.81 against 3.13. `scripts/pair_swing_torch.py` prints
# these readings.
REGISTERED_PX = 5.0
REGISTERED_PAIR_TOL = 1.0


def test_benchmark_mace_on_the_val_directory_and_on_pairs_made_here(tiny_matcher, valdir):
    """Float images read from the directory's PNGs, and uint8 pairs made
    here as the directory's writer makes them (the JAX package's
    `eval_pairs`, rounded to uint8), which the benchmark divides by 255: the
    same pairs, so the same MACE under the same keys. Then the port's own
    `eval_pairs`: per pair against those, on the pairs both register."""
    from gfnet_tpu_torch.data.dataset import HomographyDataset

    ds = HomographyDataset(dataset="synthetic_tiny", mode="val", data_path=str(valdir),
                           input_resolution=(112, 112))
    mace, errors = benchmark_mace(tiny_matcher, [ds[i] for i in range(2)], num_matches=500)
    assert len(errors) == 2 and mace == float(np.mean(errors))
    assert all(0.0 <= e <= 70.0 for e in errors)
    to_u8 = lambda x: (np.clip(x, 0, 1) * 255).round().astype(np.uint8)  # tools/make_synth_valdir.py
    pairs = [{"im_A": to_u8(p["im_A"]), "im_B": to_u8(p["im_B"]), "H_s2t": p["H_s2t"]}
             for p in jax_eval_pairs(2, 112, 0.3, seed=1234)]
    mace_u8, errors_u8 = benchmark_mace(tiny_matcher, pairs, num_matches=500)
    assert abs(mace_u8 - mace) < 0.05 * max(mace, 1.0)
    _, port_errors = benchmark_mace(tiny_matcher, eval_pairs(2, 112, 0.3, seed=1234, device="cpu"),
                                    num_matches=500)
    registered = [(p, j) for p, j in zip(port_errors, errors_u8) if max(p, j) < REGISTERED_PX]
    assert registered, (port_errors, errors_u8)
    for p, j in registered:
        assert abs(p - j) <= REGISTERED_PAIR_TOL, (port_errors, errors_u8)


def test_demo_estimation_from_files_writes_the_plot(tiny_matcher, valdir, tmp_path):
    d = valdir / "test" / "synth_1k_112x112"
    out = tmp_path / "match.png"
    err, runtime, H = demo_estimation(tiny_matcher, str(d / "source" / "00000.png"),
                                      str(d / "target" / "00000.png"),
                                      str(d / "H_s2t" / "00000.json"), num_matches=500,
                                      visualize=True, out_path=str(out))
    assert H.shape == (3, 3) and np.all(np.isfinite(H))
    assert 0.0 <= err and runtime > 0 and out.stat().st_size > 0


def test_demo_says_what_is_missing_without_pil(tiny_matcher, valdir, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    src = str(valdir / "test" / "synth_1k_112x112" / "source" / "00000.png")
    with pytest.raises(RuntimeError, match="PIL"):
        demo_estimation(tiny_matcher, src, src)


def test_cli_test_runs_the_tiny_config_on_the_cpu(valdir, tmp_path, capsys):
    args = ["--tiny", "--device", "cpu", "--dataset", "synthetic_tiny", "--data_path", str(valdir),
            "--dinov2_weights", str(tmp_path / "absent.npz"), "--ckpt_path", TINY_HEAD]
    serial = cli_test.main(args + ["--max_pairs", "1"])
    out = capsys.readouterr().out
    assert "random backbone" in out and f"loaded checkpoint {TINY_HEAD}" in out
    assert json.loads(out[out.index("{"):]) == serial
    assert sorted(serial) == sorted([f"auc@{t}_synthetic_tiny" for t in (3, 5, 10, 20)]
                                    + ["mace_synthetic_tiny", "runtime_synthetic_tiny"])
    assert 0.0 <= serial["mace_synthetic_tiny"] <= 70.0
    batched = cli_test.main(args + ["--batch", "2", "--max_pairs", "2"])
    assert batched["batch_size_synthetic_tiny"] == 2
    assert 0.0 <= batched["mace_synthetic_tiny"] <= 70.0


def test_cli_test_asking_for_cuda_without_a_gpu_raises(valdir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        cli_test.main(["--tiny", "--dataset", "synthetic_tiny", "--data_path", str(valdir),
                       "--dinov2_weights", str(tmp_path / "absent.npz")])


def test_cli_train_eval_after_runs_the_benchmark(valdir, tmp_path, capsys):
    args = ["--tiny", "--device", "cpu", "--dataset", "synthetic_tiny", "--data_path", str(valdir),
            "--workspace", str(tmp_path), "--gpu_batch_size", "1", "--total_pairs", "0",
            "--eval_after", "--eval_max_pairs", "1", "--dinov2_weights", str(tmp_path / "absent.npz")]
    cli_train.main(args, batches=iter(()))
    out = capsys.readouterr().out
    results = json.loads(out[out.index("{"):])
    assert sorted(results) == sorted([f"auc@{t}_synthetic_tiny" for t in (3, 5, 10, 20)]
                                     + ["mace_synthetic_tiny", "runtime_synthetic_tiny"])
    logged = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert "mace_synthetic_tiny" in logged[-1]


# ----------------------------------------------------------- .pth loading
def test_from_pretrained_reads_pth_head_and_dinov2(tmp_path):
    cfg = tiny_test_config()
    head = GFNet(cfg, dtype=torch.float32)
    head.load_state_dict(jax_head_state(cfg, 4))
    sd = head.state_dict()
    saved = dict(sd, **{"fpn_decoder.0.1.num_batches_tracked": torch.tensor(3)})
    torch.save({"model": saved, "n": 12345, "lr_scheduler": {"last_epoch": 3}}, tmp_path / "latest.pth")
    vit = VisionTransformer(cfg.dino, dtype=torch.float32)
    vsd = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(5))
           for k, v in vit.state_dict().items()}
    torch.save(dict(vsd, mask_token=torch.zeros(1, cfg.dino.d_model)), tmp_path / "dinov2.pth")
    conf = {"dino_cfg": {"d_model": cfg.dino.d_model, "depth": cfg.dino.depth,
                         "num_heads": cfg.dino.num_heads, "pos_embed_size": cfg.dino.pos_embed_size,
                         "decoder_cfg": {"num_cross_attn": 1, "nhead": 2, "train_avg_length": 64}},
            "encoder_cfg": {"feat_chs": list(cfg.encoder.feat_chs)},
            "matcher": {"num_grid": list(cfg.matcher.num_grid), "radius": list(cfg.matcher.radius),
                        "displacement_dim": list(cfg.matcher.displacement_dim)},
            "initial_res": list(cfg.initial_res), "upsample_res": list(cfg.upsample_res)}
    (tmp_path / "tiny.json").write_text(json.dumps(conf))
    m = GFNetMatcher.from_pretrained(str(tmp_path / "tiny.json"), str(tmp_path / "latest.pth"),
                                     dinov2_weights=str(tmp_path / "dinov2.pth"),
                                     device="cpu", dtype=torch.float32)
    assert m.cfg == cfg
    for k, v in sd.items():
        assert torch.equal(m.head.state_dict()[k], v), k
    for k, v in vsd.items():
        assert torch.equal(m.vit.state_dict()[k], v), k


def test_orbax_directory_says_how_to_convert(tmp_path):
    from gfnet_tpu_torch.utils.convert import load_head

    with pytest.raises(ValueError, match="npz"):
        load_head(str(tmp_path))


def test_what_the_gpu_smoke_script_runs_needs_neither_cv2_nor_pil():
    """The card's machine has neither: the modules `chip_smoke.py` imports,
    and making evaluation pairs, must not load them."""
    import subprocess

    code = (
        "import sys, torch\n"
        "import chip_smoke\n"
        "import gfnet_tpu_torch.cli.train, gfnet_tpu_torch.eval.benchmark, gfnet_tpu_torch.eval.flows\n"
        "import gfnet_tpu_torch.matcher.api, gfnet_tpu_torch.train.checkpoint, gfnet_tpu_torch.train.step\n"
        "from gfnet_tpu_torch.eval.synthetic import eval_pairs\n"
        "eval_pairs(1, 112, 0.3, cross_modal=True, device='cpu')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('cv2', 'PIL', 'jax', 'flax', 'gfnet_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
