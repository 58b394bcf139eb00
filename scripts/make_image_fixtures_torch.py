#!/usr/bin/env python3
"""Write the image fixtures of `tests/test_torch_imageio.py` and `chip_smoke.py`.

    python scripts/make_image_fixtures_torch.py [--out tests/data/images]

Each image is made from a numpy seed and written with PIL (the 4:4:0 JPEG,
which PIL cannot write, by the small baseline encoder below; the PNGs that
must hold every row filter by hand), and beside it `<name>.npz` holds PIL's
decode: `rgb`, `np.asarray(Image.open(f).convert("RGB"))`, and, where it
differs, `native`, `np.asarray(Image.open(f))`. Needs PIL; the files are committed, so
nothing else needs it.
"""

from __future__ import annotations

import argparse
import io
import os
import struct
import zlib

import numpy as np

W, H = 37, 53  # odd sizes: partial MCUs and partial chroma blocks


def texture(rng: np.random.Generator, h: int, w: int, noise: float = 18.0) -> np.ndarray:
    """Blocks of colour, bilinear-smoothed, plus noise: edges, gradients and
    fine detail, so every coefficient band is used."""
    coarse = rng.uniform(0, 255, (h // 6 + 2, w // 6 + 2, 3))
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    c = coarse
    img = ((1 - fy) * (1 - fx) * c[y0][:, x0] + (1 - fy) * fx * c[y0][:, x0 + 1]
           + fy * (1 - fx) * c[y0 + 1][:, x0] + fy * fx * c[y0 + 1][:, x0 + 1])
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# ------------------------------------------- a baseline encoder (4:4:0 only)
_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
                    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
                    15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
                    62, 63])
# JPEG Annex K: luminance quantization and the standard Huffman tables
_QL = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40,
                57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24,
                35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98,
                112, 100, 103, 99])
_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_VALS = list(range(12))
_AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16171819"
    "1a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a7374757677"
    "78797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")


def _codes(bits, vals) -> dict:
    out, code, k = {}, 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


def encode_440(rgb: np.ndarray, q: np.ndarray = _QL) -> bytes:
    """Baseline JPEG of `rgb` with Y sampled 1x2 against Cb and Cr (4:4:0),
    one quantization and one pair of Huffman tables for all components."""
    h, w = rgb.shape[:2]
    x = rgb.astype(np.float64)
    ycc = np.stack([0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
                    -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128,
                    0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128], -1)
    mw, mh = -(-w // 8) * 8, -(-h // 16) * 16
    ycc = np.pad(ycc, ((0, mh - h), (0, mw - w), (0, 0)), mode="edge")
    chroma = ycc[:, :, 1:].reshape(mh // 2, 2, mw, 2).mean(axis=1)
    dct, dc_codes, ac_codes = _dct_matrix(), _codes(_DC_BITS, _DC_VALS), _codes(_AC_BITS, _AC_VALS)
    bits, pred = _Bits(), [0, 0, 0]

    def block(plane, by, bx, comp):
        b = plane[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] - 128
        zz = np.round((dct @ b @ dct.T).reshape(64)[_ZIGZAG] / q[_ZIGZAG]).astype(int)
        for k, v in enumerate(zz):
            size = int(abs(v)).bit_length()
            enc = v if v >= 0 else v + (1 << size) - 1
            if k == 0:
                diff = v - pred[comp]
                pred[comp] = v
                size = int(abs(diff)).bit_length()
                bits.put(*dc_codes[size])
                bits.put(diff if diff >= 0 else diff + (1 << size) - 1, size)
                run = 0
                continue
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac_codes[0xF0])
                run -= 16
            bits.put(*ac_codes[(run << 4) | size])
            bits.put(enc, size)
            run = 0
        if run:
            bits.put(*ac_codes[0x00])

    for my in range(mh // 16):
        for mx in range(mw // 8):
            block(ycc[:, :, 0], 2 * my, mx, 0)
            block(ycc[:, :, 0], 2 * my + 1, mx, 0)
            block(chroma[..., 0], my, mx, 1)
            block(chroma[..., 1], my, mx, 2)
    seg = lambda m, body: struct.pack(">BBH", 0xFF, m, len(body) + 2) + body
    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += seg(0xDB, bytes([0]) + bytes(int(v) for v in q[_ZIGZAG]))
    out += seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x12, 0, 2, 0x11, 0, 3, 0x11, 0]))
    out += seg(0xC4, bytes([0x00] + _DC_BITS + _DC_VALS))
    out += seg(0xC4, bytes([0x10] + _AC_BITS) + _AC_VALS)
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x00, 3, 0x00, 0, 63, 0]))
    return out + bits.flush() + b"\xff\xd9"


# --------------------------------------------- PNGs with every row filter
def _filter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    r, p = row.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (a + p) >> 1
    else:
        pa, pb, pc = np.abs(p - c), np.abs(a - c), np.abs(a + p - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) & 0xFF).astype(np.uint8)


def png_every_filter(img: np.ndarray) -> bytes:
    """8-bit gray or RGB PNG whose row y is filtered with type y % 5."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch)
    prev, raw = np.zeros(w * ch, np.uint8), bytearray()
    for y in range(h):
        raw.append(y % 5)
        raw += _filter_row(y % 5, rows[y], prev, ch).tobytes()
        prev = rows[y]
    chunk = lambda k, b: struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw), 9)) + chunk(b"IEND", b""))


def main(argv=None) -> None:
    from PIL import Image

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "..", "tests", "data", "images"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(20261017)
    rgb = texture(rng, H, W)
    files: dict[str, bytes] = {}

    def save(name: str, im, fmt: str, **kw) -> None:
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        files[name] = buf.getvalue()

    for q in (50, 95):
        for sub, tag in ((0, "444"), (1, "422"), (2, "420")):
            save(f"jpeg_{tag}_q{q}.jpg", Image.fromarray(rgb), "JPEG", quality=q, subsampling=sub)
        save(f"jpeg_gray_q{q}.jpg", Image.fromarray(rgb).convert("L"), "JPEG", quality=q)
    save("jpeg_420_restart.jpg", Image.fromarray(rgb), "JPEG", quality=80, subsampling=2,
         restart_marker_blocks=1)
    save("jpeg_420_progressive.jpg", Image.fromarray(rgb), "JPEG", quality=80, subsampling=2,
         progressive=True)
    save("jpeg_gray_progressive.jpg", Image.fromarray(rgb).convert("L"), "JPEG", quality=80,
         progressive=True)
    save("jpeg_rgb_adobe.jpg", Image.fromarray(rgb), "JPEG", quality=80, keep_rgb=True)
    files["jpeg_440.jpg"] = encode_440(rgb)
    save("jpeg_420_640x480.jpg", Image.fromarray(texture(rng, 480, 640, noise=3.0)), "JPEG",
         quality=75, subsampling=2)

    rgba = np.concatenate([rgb, rng.integers(0, 256, (H, W, 1), dtype=np.uint8)], axis=-1)
    save("png_rgb.png", Image.fromarray(rgb), "PNG")
    save("png_rgba.png", Image.fromarray(rgba), "PNG")
    save("png_gray.png", Image.fromarray(rgb).convert("L"), "PNG")
    save("png_gray_alpha.png", Image.fromarray(rgba).convert("LA"), "PNG")
    save("png_palette.png", Image.fromarray(rgb).quantize(200), "PNG")
    save("png_palette_4bit.png", Image.fromarray(rgb).quantize(16), "PNG", bits=4)
    save("png_gray_1bit.png", Image.fromarray(rgb).convert("1"), "PNG")
    files["png_rgb_every_filter.png"] = png_every_filter(rgb)
    files["png_gray_every_filter.png"] = png_every_filter(np.asarray(Image.fromarray(rgb).convert("L")))

    for name, data in sorted(files.items()):
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        im = Image.open(io.BytesIO(data))
        decoded = {"rgb": np.asarray(im.convert("RGB"))}
        if im.mode != "RGB":
            decoded["native"] = np.asarray(im)
        np.savez_compressed(os.path.join(args.out, os.path.splitext(name)[0] + ".npz"), **decoded)
        print(f"{name}: {len(data)} bytes, PIL mode {im.mode}")


if __name__ == "__main__":
    main()
