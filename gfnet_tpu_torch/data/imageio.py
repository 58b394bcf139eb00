"""Image files without PIL: JPEG and PNG in, PNG out.

The port's `Image.open(path).convert("RGB")` (`read_image`) and
`np.asarray(Image.open(path))` (`read_image(path, mode=None)`), so that the
dataset path needs no PIL on the card's machine. JPEG
decodes in host C++ (`csrc/imageio.cpp`: baseline, extended sequential and
progressive Huffman, 8-bit, 1 or 3 components, sampling factors up to 2×2,
restart markers, Adobe's transform flag) with libjpeg's default arithmetic,
so the pixels equal PIL's. PNG inflates with the standard library's `zlib`
and undoes its row filters in the same C++ library; 8-bit gray, gray +
alpha, RGB, RGBA, and palette or gray at 1, 2, 4 or 8 bits are read.
Arithmetic-coded, 12-bit, lossless, hierarchical and CMYK JPEG, and Adam7 or
16-bit PNG, raise with the file and the mode.

The library builds at first use with the host C++ compiler (`$CXX`, else
`c++` or `g++`; `-O3 -shared -fPIC`) into `gfnet_tpu_torch/_build/imageio_<hash>/`
and is loaded with `ctypes`, which releases the interpreter lock during a
decode, so `read_images` decodes in a thread pool.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "imageio.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libgfnet_imageio.so"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_ERR_LEN = 512


class ImageFormatError(ValueError):
    """A file this module does not decode: its format, or a mode of it."""


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found ($CXX, c++, g++): gfnet_tpu_torch/data/imageio.py "
                       "builds its image decoder with one")


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (once a source hash) and load the image library."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"imageio_{digest}"
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}"
        proc = subprocess.run([_compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}")
        os.replace(tmp, lib_path)  # a concurrent loader never sees a half-written file
    lib = ctypes.CDLL(str(lib_path))
    p, i, i64, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_char_p
    ip = ctypes.POINTER(ctypes.c_int)
    lib.gfnet_jpeg_info.argtypes = [p, i64, ip, ip, ip, s, i]
    lib.gfnet_jpeg_info.restype = i
    lib.gfnet_jpeg_decode.argtypes = [p, i64, p, i64, s, i]
    lib.gfnet_jpeg_decode.restype = i
    lib.gfnet_png_unfilter.argtypes = [p, i64, i, i64, i, p, s, i]
    lib.gfnet_png_unfilter.restype = i
    return lib


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) gray or (H, W, 3) RGB uint8, as PIL decodes the JPEG `data`."""
    lib = load_library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.gfnet_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                           err, _ERR_LEN):
        raise ImageFormatError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, c.value), np.uint8)
    if lib.gfnet_jpeg_decode(data, len(data), out.ctypes.data, out.size, err, _ERR_LEN):
        raise ImageFormatError(f"{name}: {err.value.decode()}")
    return out[..., 0] if c.value == 1 else out


def _png_chunks(data: bytes, name: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ImageFormatError(f"{name}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ImageFormatError(f"{name}: broken PNG file (CRC of chunk {kind!r})")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ImageFormatError(f"{name}: PNG file without IEND")


def _unpack_bits(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """(H, row_bytes) packed samples of `depth` bits → (H, width) uint8."""
    if depth == 8:
        return rows[:, :width]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width].astype(np.uint8)


def decode_png(data: bytes, name: str = "<bytes>", mode: str | None = "RGB") -> np.ndarray:
    """The PNG `data` as PIL gives it: `mode="RGB"` → `convert("RGB")`
    (alpha dropped, gray replicated, palette looked up); `mode=None` →
    `np.asarray(Image.open(...))` (gray (H, W), gray + alpha (H, W, 2), RGB,
    RGBA, palette indices; 1-bit gray 0/1)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ImageFormatError(f"{name}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ImageFormatError(f"{name}: PNG file without IHDR")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ImageFormatError(f"{name}: interlaced (Adam7) PNG is not decoded")
    if depth == 16:
        raise ImageFormatError(f"{name}: 16-bit PNG is not decoded")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if channels is None or depth not in (1, 2, 4, 8) or (depth != 8 and color not in (0, 3)):
        raise ImageFormatError(f"{name}: PNG colour type {color} at {depth} bits is not decoded")
    if color == 3 and palette is None:
        raise ImageFormatError(f"{name}: palette PNG without PLTE")
    raw = zlib.decompress(b"".join(idat))
    row_bytes = (width * channels * depth + 7) // 8
    rows = np.empty((height, row_bytes), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load_library().gfnet_png_unfilter(raw, len(raw), height, row_bytes,
                                         max(channels * depth // 8, 1), rows.ctypes.data,
                                         err, _ERR_LEN):
        raise ImageFormatError(f"{name}: {err.value.decode()}")
    if channels > 1:
        img = rows.reshape(height, width, channels)
    else:
        img = _unpack_bits(rows, depth, width)
        if color == 0 and depth in (2, 4):  # PIL's "L;2" / "L;4" scale to 0..255
            img = img * np.uint8(255 // ((1 << depth) - 1))
    if mode is None:
        return img
    if mode != "RGB":
        raise ValueError(f"mode {mode!r}: only 'RGB' or None")
    if color == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[img]
    if color == 0:
        img = img * np.uint8(255) if depth == 1 else img
        return np.repeat(img[..., None], 3, axis=-1)
    if color == 4:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_image(path: str | os.PathLike, mode: str | None = "RGB") -> np.ndarray:
    """Read a JPEG or PNG file as PIL would: `mode="RGB"` is
    `np.asarray(Image.open(path).convert("RGB"))`, (H, W, 3) uint8;
    `mode=None` is `np.asarray(Image.open(path))`."""
    name = os.fspath(path)
    with open(name, "rb") as f:
        data = f.read()
    if data.startswith(b"\xff\xd8"):
        img = decode_jpeg(data, name)
        if mode == "RGB" and img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, name, mode)
    raise ImageFormatError(f"{name}: neither JPEG nor PNG")


def read_images(paths, threads: int = 4, mode: str | None = "RGB") -> list[np.ndarray]:
    """`read_image` of each path, in order, decoded by `threads` threads
    (0 or 1: in the calling thread)."""
    paths = list(paths)
    if threads <= 1 or len(paths) <= 1:
        return [read_image(p, mode) for p in paths]
    with ThreadPoolExecutor(min(threads, len(paths))) as pool:
        return list(pool.map(functools.partial(read_image, mode=mode), paths))


def write_png(path: str | os.PathLike, img, compress_level: int = 6) -> None:
    """Write (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 as an 8-bit
    PNG (filter None on every row). A tensor is copied to the host first."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    color = {2: 0, 3: {1: 0, 3: 2, 4: 6}.get(img.shape[-1])}.get(img.ndim)
    if color is None:
        raise ValueError(f"write_png takes (H, W), (H, W, 3) or (H, W, 4), got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), compress_level)) + chunk(b"IEND", b""))
    tmp = f"{os.fspath(path)}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
