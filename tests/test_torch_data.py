"""The port's dataset path against the JAX package's, on the CPU.

`data/augment.py` (tensor ops) against `gfnet_tpu/data/augment.py` (PIL)
under one numpy `Generator`; `data/homography_synth.random_homography_pair`
(tensor ops) against the cv2 one; `data/dataset.HomographyDataset` and
`BatchLoader` against the JAX package's on directories written here with
PIL in the val, googlemap and glunet layouts; both CLIs over on-disk
directories with PIL and cv2 blocked; and `tools/make_synth_valdir` against
the JAX package's tool.

Gates (PERF.md §2):
- every augmentation, the grayscale and HSV conversions, the resize and the
  val and glunet items: 0 levels (PIL's integer arithmetic is repeated);
  the planted faults (hue one step off, blur radius ×1.1, contrast's mean
  truncated) read at least one level;
- googlemap items (cv2's float warp and bicubic resize against the tensor
  ops): `SYNTH_ATOL` in normalized units;
- H_s2t: float32 rounding (rtol 2e-6, as `eval_pairs` is held).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

pytest.importorskip("cv2")

from gfnet_tpu.data import augment as jaug  # noqa: E402
from gfnet_tpu.data.dataset import BatchLoader as JBatchLoader  # noqa: E402
from gfnet_tpu.data.dataset import HomographyDataset as JDataset  # noqa: E402
from gfnet_tpu.data.homography_synth import random_homography_pair as j_pair  # noqa: E402
from gfnet_tpu_torch.data import augment  # noqa: E402
from gfnet_tpu_torch.data.dataset import BatchLoader, HomographyDataset  # noqa: E402
from gfnet_tpu_torch.data.homography_synth import random_homography_pair  # noqa: E402
from gfnet_tpu_torch.data.imageio import read_image  # noqa: E402
from torch_cpu import child_env, one_thread  # noqa: E402, F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_HEAD = os.path.join(REPO, "workspace", "trained_head_tiny.npz")
# googlemap items against JAX's, normalized units: sound runs read at most
# 1.7e-5 (cv2's float arithmetic against torch's); warps half a pixel off
# read far above (`test_planted_pair_synthesis_fault_...`)
SYNTH_ATOL = 1e-4
H_RTOL = 2e-6


def texture(seed: int, h: int, w: int) -> np.ndarray:
    """Smooth colour blocks plus noise, uint8 (h, w, 3)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, 3)).astype(np.float32)
    img = torch.nn.functional.interpolate(torch.from_numpy(coarse).permute(2, 0, 1)[None], size=(h, w),
                                          mode="bilinear", align_corners=False)[0].permute(1, 2, 0).numpy()
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def _pil_u8(im) -> np.ndarray:
    return np.asarray(im, np.uint8)


# ------------------------------------------------------------ augmentations
@pytest.mark.parametrize("params", [(0.2, 0.2, 0.2, 0.2), (0.6, 0.6, 0.6, 0.2), (0.4, 0.0, 0.0, 0.0),
                                    (0.0, 0.5, 0.0, 0.0), (0.0, 0.0, 0.0, 0.3)],
                         ids=["real", "glunet", "brightness", "contrast", "hue"])
def test_color_jitter_equals_the_jax_package(params):
    img = texture(1, 45, 38)
    for seed in range(6):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        want = _pil_u8(jaug.ColorJitter(*params)(Image.fromarray(img), jr))
        got = augment.ColorJitter(*params)(torch.from_numpy(img), tr).numpy()
        np.testing.assert_array_equal(got, want)
        assert jr.uniform() == tr.uniform()  # the same draws were taken


def test_grayscale_blur_and_resize_shorter_equal_the_jax_package():
    img = texture(2, 41, 57)
    for seed in range(6):
        for jop, top in ((jaug.RandomGrayscale(0.5), augment.RandomGrayscale(0.5)),
                         (jaug.RandomGaussianBlur(p=0.7), augment.RandomGaussianBlur(p=0.7)),
                         (jaug.ResizeShorter(30 + 7 * seed), augment.ResizeShorter(30 + 7 * seed))):
            jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
            want = _pil_u8(jop(Image.fromarray(img), jr))
            got = top(torch.from_numpy(img), tr).numpy()
            np.testing.assert_array_equal(got, want)
            assert jr.uniform() == tr.uniform()


@pytest.mark.parametrize("which", ["real", "glunet"])
def test_transform_pipelines_equal_the_jax_package(which):
    img = texture(3, 70, 90)
    jt = jaug.real_dataset_transforms() if which == "real" else jaug.glunet_transforms()
    tt = augment.real_dataset_transforms() if which == "real" else augment.glunet_transforms()
    for seed in range(2):
        want = _pil_u8(jt(Image.fromarray(img), np.random.default_rng(seed)))
        got = tt(torch.from_numpy(img), np.random.default_rng(seed)).numpy()
        np.testing.assert_array_equal(got, want)


def test_hsv_conversions_equal_pil_on_every_colour():
    v = np.arange(256, dtype=np.uint8)
    every = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(augment.rgb_to_hsv(torch.from_numpy(every)).numpy(),
                                  np.asarray(Image.fromarray(every).convert("HSV")))
    np.testing.assert_array_equal(augment.hsv_to_rgb(torch.from_numpy(every)).numpy(),
                                  np.asarray(Image.fromarray(every, "HSV").convert("RGB")))


@pytest.mark.parametrize("size", [(30, 20), (61, 47), (200, 150), (13, 90)])
def test_resize_equals_pil(size):
    img = texture(4, 61, 47)
    for mode, pil_mode in (("bilinear", Image.BILINEAR), ("bicubic", Image.BICUBIC)):
        want = _pil_u8(Image.fromarray(img).resize(size[::-1], pil_mode))
        np.testing.assert_array_equal(augment.resize(torch.from_numpy(img), size, mode).numpy(), want)


def _mean_gray_fraction(img: np.ndarray) -> float:
    gray = augment.to_gray(torch.from_numpy(img)).numpy().astype(np.int64)
    return gray.sum() / gray.size % 1.0


@pytest.mark.parametrize("fault", ["hue_one_step", "blur_radius_x1.1", "contrast_mean_truncated"])
def test_planted_augmentation_faults_read_outside_the_zero_gate(fault):
    # the first texture whose mean gray rounding and truncation tell apart
    img = next(im for im in (texture(seed, 48, 40) for seed in range(5, 100)) if _mean_gray_fraction(im) >= 0.5)
    t = torch.from_numpy(img)
    pil = Image.fromarray(img)
    if fault == "hue_one_step":
        hsv = np.array(pil.convert("HSV"), np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(0.1 * 255)) % 256
        want = _pil_u8(Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB"))
        sound = augment.hue(t, 0.1).numpy()
        planted = augment.hue(t, 0.1 + 1 / 255).numpy()
    elif fault == "blur_radius_x1.1":
        from PIL import ImageFilter

        want = _pil_u8(pil.filter(ImageFilter.GaussianBlur(1.3)))
        sound = augment.gaussian_blur(t, 1.3).numpy()
        planted = augment.gaussian_blur(t, 1.3 * 1.1).numpy()
    else:
        from PIL import ImageEnhance

        want = _pil_u8(ImageEnhance.Contrast(pil).enhance(0.5))
        sound = augment.contrast(t, 0.5).numpy()
        gray = augment.to_gray(t).to(torch.int64)
        planted = augment.blend(torch.full_like(t, int(gray.sum().item() / gray.numel())), t, 0.5).numpy()
    np.testing.assert_array_equal(sound, want)
    diff = np.abs(planted.astype(int) - want.astype(int))
    print(f"planted {fault}: max {diff.max()} levels, {(diff > 0).sum()} of {diff.size} values differ")
    assert diff.max() >= 1, fault


# ------------------------------------------------------------ pair synthesis
def test_pair_synthesis_equals_the_cv2_one_to_interpolation_rounding():
    """Same numpy draws, so the same crop and homographies; cv2's float
    warp and bicubic resize against the tensor ops, here with the texture
    resized first (crop larger than the image)."""
    a = texture(6, 150, 170).astype(np.float32) / 255
    b = texture(7, 150, 170).astype(np.float32) / 255
    for crop in (100, 160):
        kw = dict(crop_size=crop, input_hw=(64, 64), deformation_ratio=0.3, bi=True)
        want = j_pair(a, b, rng=np.random.default_rng(8), **kw)
        got = random_homography_pair(torch.from_numpy(a), torch.from_numpy(b), rng=np.random.default_rng(8), **kw)
        np.testing.assert_allclose(got[2], want[2], rtol=H_RTOL, atol=1e-6 * np.abs(want[2]).max())
        for g, w in zip(got[:2], want[:2]):  # [0, 1] units: SYNTH_ATOL times the smallest std
            assert np.abs(g.numpy() - w).max() <= SYNTH_ATOL * 0.224


# ------------------------------------------------------------------ datasets
@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Three items each in val (sources of other sizes than 112², so the
    bicubic resize acts), googlemap (300 x 260 JPEGs: bottom crop, then
    ResizeShorter(640)) and glunet (JPEG pairs, stored H, mask) layouts,
    written with PIL."""
    root = tmp_path_factory.mktemp("datasets")
    val = root / "test" / "synth_1k_112x112"
    gm = root / "train" / "GoogleMap"
    gl = root / "train" / "glunet_448x448_occlusion"
    for d in (val / "source", val / "target", val / "H_s2t", gm / "map", gm / "satellite",
              gl / "target", gl / "source", gl / "mask", gl / "H_s2t"):
        d.mkdir(parents=True)
    rng = np.random.default_rng(9)
    for i in range(3):
        Image.fromarray(texture(10 + i, 130 + 10 * i, 120)).save(val / "source" / f"{i:05d}.png")
        Image.fromarray(texture(20 + i, 112, 112)).save(val / "target" / f"{i:05d}.png")
        (val / "H_s2t" / f"{i:05d}.json").write_text(json.dumps({"H": (np.eye(3) + rng.normal(0, 1e-2, (3, 3))).tolist()}))
        m = texture(30 + i, 260, 300)
        Image.fromarray(m).save(gm / "map" / f"{i:03d}.jpg", quality=90)
        Image.fromarray(255 - m).save(gm / "satellite" / f"{i:03d}.jpg", quality=90)
        g = texture(40 + i, 112, 112)
        Image.fromarray(g).save(gl / "target" / f"{i:03d}.jpg", quality=90)
        Image.fromarray(np.ascontiguousarray(g[:, ::-1])).save(gl / "source" / f"{i:03d}.jpg", quality=90)
        Image.fromarray((rng.uniform(0, 1, (112, 112)) > 0.5).astype(np.uint8) * 255).save(gl / "mask" / f"{i:03d}.jpg")
        (gl / "H_s2t" / f"{i:03d}.json").write_text(json.dumps({"H": (np.eye(3) + rng.normal(0, 1e-3, (3, 3))).tolist()}))
    return root


def _assert_items_agree(got: dict, want: dict, image_atol: float) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k.endswith("_path"):
            assert g == w
        elif k == "H_s2t":
            assert isinstance(g, np.ndarray) and g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=H_RTOL, atol=1e-6 * np.abs(w).max())
        else:
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, k
            assert np.abs(g.numpy() - w).max() <= image_atol, (k, np.abs(g.numpy() - w).max())


@pytest.mark.parametrize("name,mode,atol", [("synthetic_tiny", "val", 0.0), ("googlemap", "train", SYNTH_ATOL),
                                            ("glunet_448x448_occlusion", "train", 0.0)],
                         ids=["val", "googlemap", "glunet"])
def test_dataset_items_equal_the_jax_package(data_root, name, mode, atol):
    want = JDataset(name, mode, str(data_root), (112, 112), seed=3)
    got = HomographyDataset(name, mode, str(data_root), (112, 112), seed=3, device="cpu")
    assert len(got) == len(want) == 3 and got.imgs0 == want.imgs0 and got.imgs1 == want.imgs1
    for i in range(3):
        _assert_items_agree(got[i], want[i], atol)


def test_planted_dataset_faults_read_outside_the_gates(data_root):
    """The val item with the source's rescale taken with w and h swapped,
    and with its channels reversed, against the sound item."""
    ds = HomographyDataset("synthetic_tiny", "val", str(data_root), (112, 112), device="cpu")
    raw = ds.read(0)
    sound = ds.process(0, raw)
    h1, w1 = raw["img1"].shape[:2]
    assert h1 != w1
    S0 = np.diag([112 / 112, 112 / 112, 1.0]).astype(np.float32)
    S1_swapped = np.diag([112 / h1, 112 / w1, 1.0]).astype(np.float32)
    planted = S1_swapped @ raw["H"] @ np.linalg.inv(S0)
    h_rel = np.abs(planted - sound["H_s2t"]).max() / np.abs(sound["H_s2t"]).max()
    flipped = (sound["im_A"].flip(-1) - sound["im_A"]).abs().max().item()
    print(f"planted: H rescaled with w and h swapped {h_rel:.3g} relative; channels reversed {flipped:.3g}")
    assert h_rel > 1e3 * H_RTOL and flipped > 10 / 255


def test_planted_pair_synthesis_fault_reads_outside_the_googlemap_gate(data_root, monkeypatch):
    """The googlemap item with the four-point warps sampling half a pixel
    to the side, against the JAX package's item."""
    import gfnet_tpu_torch.data.homography_synth as hs

    want = JDataset("googlemap", "train", str(data_root), (112, 112), seed=3)[0]
    real = hs.warp_perspective
    half = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    monkeypatch.setattr(hs, "warp_perspective", lambda img, H, hw, **kw: real(img, half @ H, hw, **kw))
    got = HomographyDataset("googlemap", "train", str(data_root), (112, 112), seed=3, device="cpu")[0]
    reading = max(np.abs(got[k].numpy() - want[k]).max() for k in ("im_A", "im_B"))
    print(f"planted half-pixel warp: {reading:.3g} (gate {SYNTH_ATOL})")
    assert reading > 10 * SYNTH_ATOL


def test_batch_loader_threads_equal_the_jax_serial_loader(data_root):
    """Any thread count gives the JAX package's `num_workers=0` stream (the
    glunet layout: its augmentations draw, and its items are bit for bit)."""
    name = "glunet_448x448_occlusion"
    jl = JBatchLoader(JDataset(name, "train", str(data_root), (112, 112), seed=1), 2, num_workers=0, seed=4)
    want = list(jl.batches(3))
    for workers in (0, 2):
        loader = BatchLoader(HomographyDataset(name, "train", str(data_root), (112, 112), seed=1, device="cpu"),
                             2, num_workers=workers, seed=4)
        try:
            got = list(loader.batches(3))
        finally:
            loader.close()
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["H_s2t", "im_A", "im_B", "mask"]
            assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32 for v in g.values())
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), w[k])


# ----------------------------------------------------------------- the CLIs
@pytest.fixture(scope="module")
def valdirs(tmp_path_factory):
    """Three 112² pairs written by the port's tool and by the JAX package's."""
    from gfnet_tpu_torch.tools import make_synth_valdir

    port, jax_dir = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")
    args = ["--n", "3", "--res", "112", "--deformation", "0.3"]
    make_synth_valdir.main(args + ["--out", str(port), "--device", "cpu"])
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import make_synth_valdir as jax_tool
    finally:
        sys.path.pop(0)
    jax_tool.main(args + ["--out", str(jax_dir)])
    return port, jax_dir


def test_valdir_tool_writes_the_jax_tools_layout_and_pairs(valdirs):
    """The same files; H to float32 rounding; images within one level on
    under 0.1% of the pixels (`eval_pairs`' gate)."""
    port, jax_dir = (d / "test" / "synth_1k_112x112" for d in valdirs)
    for sub in ("source", "target", "H_s2t"):
        assert sorted(os.listdir(port / sub)) == sorted(os.listdir(jax_dir / sub))
    for name in sorted(os.listdir(port / "source")):
        for sub in ("source", "target"):
            diff = np.abs(read_image(port / sub / name).astype(int) - read_image(jax_dir / sub / name).astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        Hp = np.asarray(json.loads((port / "H_s2t" / name.replace(".png", ".json")).read_text())["H"])
        Hj = np.asarray(json.loads((jax_dir / "H_s2t" / name.replace(".png", ".json")).read_text())["H"])
        np.testing.assert_allclose(Hp, Hj, rtol=H_RTOL, atol=1e-6 * np.abs(Hj).max())


def test_cli_test_over_the_tools_directory_equals_the_pairs_in_memory(valdirs, tmp_path):
    """PNG is lossless and the val resize at the same size a copy: the
    CLI's JSON over the port tool's directory equals the benchmark of the
    same `eval_pairs` in memory, runtime aside."""
    from gfnet_tpu_torch.cli import test as cli_test
    from gfnet_tpu_torch.config import tiny_test_config
    from gfnet_tpu_torch.eval.benchmark import HomographyBenchmark
    from gfnet_tpu_torch.eval.synthetic import eval_pairs
    from gfnet_tpu_torch.matcher import GFNetMatcher
    from gfnet_tpu_torch.utils.convert import load_head

    got = cli_test.main(["--tiny", "--device", "cpu", "--dataset", "synthetic_tiny", "--data_path",
                         str(valdirs[0]), "--dinov2_weights", str(tmp_path / "absent.npz"),
                         "--ckpt_path", TINY_HEAD, "--max_pairs", "1"])
    head, kv_norm = load_head(TINY_HEAD)
    m = GFNetMatcher(tiny_test_config().with_kv_norm(kv_norm), device="cpu", dtype=torch.bfloat16,
                     head_state=head)
    pairs = eval_pairs(1, 112, 0.3, seed=1234, device="cpu")
    pairs.dataset = "synthetic_tiny"
    want = HomographyBenchmark(pairs).run(m)
    runtime = "runtime_synthetic_tiny"
    assert {k: v for k, v in got.items() if k != runtime} == {k: v for k, v in want.items() if k != runtime}


_BLOCKED_RUN = r"""
import json, os, sys
sys.modules["PIL"] = sys.modules["cv2"] = None
import numpy as np
from gfnet_tpu_torch.cli import test as cli_test, train as cli_train
from gfnet_tpu_torch.data.imageio import write_png
from gfnet_tpu_torch.eval.synthetic import make_texture, to_uint8
from gfnet_tpu_torch.tools import make_synth_valdir
root, head = sys.argv[1], sys.argv[2]
make_synth_valdir.main(["--n", "1", "--res", "112", "--out", root, "--device", "cpu", "--name", "mscoco_1k_448x448"])
rng = np.random.default_rng(0)
d = os.path.join(root, "train", "glunet_448x448_occlusion")
for sub in ("target", "source", "mask", "H_s2t"):
    os.makedirs(os.path.join(d, sub), exist_ok=True)
for i in range(2):
    tex = to_uint8(make_texture(rng, 112))
    write_png(os.path.join(d, "target", f"{i}.jpg"), tex)  # a PNG under the name the layout uses
    write_png(os.path.join(d, "source", f"{i}.jpg"), tex.flip(1))
    write_png(os.path.join(d, "mask", f"{i}.jpg"), tex[..., 0])
    with open(os.path.join(d, "H_s2t", f"{i}.json"), "w") as f:
        json.dump({"H": np.eye(3).tolist()}, f)
common = ["--tiny", "--device", "cpu", "--data_path", root, "--dinov2_weights", os.path.join(root, "absent.npz")]
state = cli_train.main(common + ["--dataset", "glunet_448x448_occlusion", "--workspace", os.path.join(root, "ws"),
                                 "--gpu_batch_size", "1", "--total_pairs", "2", "--num_workers", "2",
                                 "--eval_after", "--eval_max_pairs", "1"])
res = cli_test.main(common + ["--dataset", "mscoco", "--ckpt_path", head, "--max_pairs", "1"])
bad = sorted(k for k, v in sys.modules.items()
             if v is not None and k.split(".")[0] in ("cv2", "PIL", "jax", "flax", "gfnet_tpu"))
print("RESULT", json.dumps({"step": state.step, "mace": res["mace_mscoco"], "bad": bad}))
"""


def test_both_clis_run_over_directories_with_pil_and_cv2_blocked(tmp_path):
    """`cli.train` over a glunet layout (with `--eval_after` on its val
    set, mscoco) and `cli.test` over a val directory, both written here
    without PIL (the pair synthesis of the googlemap layout runs in
    `test_dataset_items_equal_the_jax_package`), in a
    process where PIL and cv2 cannot be imported; no port module on the
    way imports PIL, cv2, JAX or the JAX package."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(tmp_path), TINY_HEAD], cwd=REPO, env=child_env(),
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("RESULT "))
    result = json.loads(line[len("RESULT "):])
    assert result["step"] == 2 and result["bad"] == []
    assert 0.0 <= result["mace"] <= 70.0
