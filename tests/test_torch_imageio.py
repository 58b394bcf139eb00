"""The port's image library (`gfnet_tpu_torch/data/imageio.py`,
`csrc/imageio.cpp`) against PIL.

The fixtures under `tests/data/images/` were written by
`scripts/make_image_fixtures_torch.py` with PIL, each beside PIL's decode
(`.npz`). Every one must decode to PIL's pixels bit for bit: the decoder
repeats libjpeg's integer arithmetic (islow IDCT, fancy upsampling,
fixed-point YCbCr) and PNG is lossless. The formats it does not decode raise
with the file and the mode.
"""

from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from gfnet_tpu_torch.data import imageio

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
NAMES = sorted(p.name for p in FIXTURES.iterdir() if p.suffix in (".jpg", ".png"))


def test_fixtures_cover_every_mode_the_decoder_claims():
    want = {"jpeg_444_q50.jpg", "jpeg_422_q95.jpg", "jpeg_420_q50.jpg", "jpeg_440.jpg",
            "jpeg_gray_q95.jpg", "jpeg_420_restart.jpg", "jpeg_420_progressive.jpg",
            "jpeg_gray_progressive.jpg", "jpeg_rgb_adobe.jpg", "jpeg_420_640x480.jpg",
            "png_rgb.png", "png_rgba.png", "png_gray.png", "png_gray_alpha.png", "png_palette.png",
            "png_palette_4bit.png", "png_gray_1bit.png", "png_rgb_every_filter.png",
            "png_gray_every_filter.png"}
    assert want <= set(NAMES)
    assert sum((FIXTURES / n).stat().st_size for n in NAMES) < 200_000


@pytest.mark.parametrize("name", NAMES)
def test_fixture_decodes_to_pils_pixels(name):
    ref = np.load(FIXTURES / name.replace(".jpg", ".npz").replace(".png", ".npz"))
    rgb = imageio.read_image(FIXTURES / name)
    assert rgb.dtype == np.uint8 and rgb.shape == ref["rgb"].shape
    np.testing.assert_array_equal(rgb, ref["rgb"])
    native = imageio.read_image(FIXTURES / name, mode=None)
    want = ref["native"] if "native" in ref.files else ref["rgb"]
    assert native.shape == want.shape
    np.testing.assert_array_equal(native.astype(np.int64), want.astype(np.int64))


def test_every_png_row_filter_is_present_in_the_hand_built_fixture():
    data = (FIXTURES / "png_rgb_every_filter.png").read_bytes()
    idat = b"".join(body for kind, body in imageio._png_chunks(data, "f") if kind == b"IDAT")
    w, h = 37, 53
    raw = zlib.decompress(idat)
    assert {raw[y * (3 * w + 1)] for y in range(h)} == {0, 1, 2, 3, 4}


def _sof(marker: int, precision: int = 8, comps: int = 3) -> bytes:
    body = struct.pack(">BHHB", precision, 8, 8, comps) + b"".join(bytes([i + 1, 0x11, 0]) for i in range(comps))
    return b"\xff\xd8" + struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body + b"\xff\xd9"


@pytest.mark.parametrize("data,mode", [
    (_sof(0xC9), "arithmetic-coded"), (_sof(0xCA), "arithmetic-coded"), (_sof(0xC1, precision=12), "12-bit"),
    (_sof(0xC3), "lossless"), (_sof(0xC5), "hierarchical"), (_sof(0xC0, comps=2), "2 components"),
], ids=["arithmetic", "progressive_arithmetic", "12bit", "lossless", "hierarchical", "2comp"])
def test_jpeg_modes_out_of_scope_raise_naming_the_file_and_mode(tmp_path, data, mode):
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    with pytest.raises(imageio.ImageFormatError, match=mode) as e:
        imageio.read_image(path)
    assert str(path) in str(e.value)


def test_cmyk_jpeg_raises(tmp_path):
    path = tmp_path / "cmyk.jpg"
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(path, "JPEG")
    with pytest.raises(imageio.ImageFormatError, match="CMYK"):
        imageio.read_image(path)


def test_png_modes_out_of_scope_raise(tmp_path):
    path = tmp_path / "i16.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path)
    with pytest.raises(imageio.ImageFormatError, match="16-bit"):
        imageio.read_image(path)
    data = bytearray((FIXTURES / "png_gray.png").read_bytes())
    ihdr = data.index(b"IHDR")
    data[ihdr + 16] = 1  # interlace method: Adam7
    data[ihdr + 17:ihdr + 21] = struct.pack(">I", zlib.crc32(bytes(data[ihdr:ihdr + 17])))
    path.write_bytes(bytes(data))
    with pytest.raises(imageio.ImageFormatError, match="Adam7"):
        imageio.read_image(path)
    data[ihdr + 20] ^= 0xFF  # a broken CRC
    path.write_bytes(bytes(data))
    with pytest.raises(imageio.ImageFormatError, match="CRC"):
        imageio.read_image(path)
    path.write_bytes(b"BM not an image")
    with pytest.raises(imageio.ImageFormatError, match="neither JPEG nor PNG"):
        imageio.read_image(path)


@pytest.mark.parametrize("shape", [(23, 31), (23, 31, 3), (23, 31, 4)], ids=["gray", "rgb", "rgba"])
def test_write_png_reads_back_in_pil_and_here(tmp_path, shape):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "w.png"
    imageio.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(imageio.read_image(path, mode=None), img)


def test_read_images_in_threads_equals_one_by_one():
    paths = [FIXTURES / n for n in NAMES] * 3
    threaded = imageio.read_images(paths, threads=4)
    for p, got in zip(paths, threaded):
        np.testing.assert_array_equal(got, imageio.read_image(p))


def test_jpeg_from_bytes_round_trip_through_pil_at_odd_sizes():
    """Odd sizes below one MCU and a row of one pixel, each subsampling."""
    rng = np.random.default_rng(3)
    for h, w in ((1, 1), (2, 5), (17, 3), (9, 16)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for sub in (0, 1, 2):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=90, subsampling=sub)
            want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
            np.testing.assert_array_equal(imageio.decode_jpeg(buf.getvalue()), want)
