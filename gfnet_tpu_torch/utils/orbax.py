"""Orbax checkpoints read without orbax, tensorstore or JAX.

The JAX package saves every checkpoint with Orbax (`gfnet_tpu/train/checkpoint.py`,
`utils/convert.load_head_checkpoint`). A checkpoint directory holds
`_METADATA` (JSON: each leaf's tuple path, its `value_type`, and whether the
arrays sit in an OCDBT store and in zarr 2 or zarr 3), and the arrays:

  - `use_ocdbt: true` (orbax's default): an OCDBT key-value store
    (tensorstore's "OCDBT on-disk format"): `manifest.ocdbt` names the
    versions of a B+tree; its nodes and the values they refer to sit in data
    files such as `d/<hex>` and `ocdbt.process_0/d/<hex>`. Each manifest and
    node starts with a magic number, its length, a version and a compression
    (zstd), and ends with a CRC-32C. Small values sit inline in the leaves,
    larger ones in a data file at (offset, length), uncompressed there.
  - `use_ocdbt: false`: the same keys as files under the directory.

Keys are `<dotted leaf path>/.zarray` and its chunks (`/0`, `/0.0`, ...) for
zarr 2, or `<dotted leaf path>/zarr.json` and `/c/0/0` for zarr 3. Chunks
are zstd frames (zarr 2 `compressor`, zarr 3 `zstd` codec; orbax's zarr 3
wraps them in a `sharding_indexed` shard with a CRC-32C'd index).

zstd and CRC-32C are decoded by `csrc/zstd.cpp`, built at first use
(`utils/hostlib.py`) and bound with `ctypes`; this module parses the small
structures. Whatever it does not read raises `OrbaxFormatError` naming the
file or key, and the offset where it applies: another compression, a
numbered manifest, a zarr filter or codec, a dtype outside
`<f4 <f8 <f2 <i4 <i8 <u4 |u1 |b1 bfloat16`.

Every path a checkpoint names (a data file in the OCDBT tables, a key of
`_METADATA`) must lie under its directory; one that leads out of it raises.

`read_checkpoint(path)` returns the leaves as a tree of dicts
nested along `_METADATA`'s paths (tuple and list indices as the strings
orbax writes, "0", "1", ...): numpy arrays, except bfloat16 leaves, which are
`torch.bfloat16` tensors. Leaves whose `value_type` is "None" or that are
marked `skip_deserialize` are left out; `_sharding` is ignored.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import json
import math
import os
import struct
from pathlib import Path
from typing import Callable, Iterable

import numpy as np

from gfnet_tpu_torch.utils.hostlib import BUILD_ROOT, build_library

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "zstd.cpp"
LIB_NAME = "libgfnet_zstd.so"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1  # a version's root offset when its tree is empty
_ERR_LEN = 512
_MAX_UNKNOWN_SIZE = 1 << 31  # a zstd frame that does not state its size may grow to this


class OrbaxFormatError(ValueError):
    """A checkpoint, or a part of one, that this module does not read."""


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (once a source hash) and load the zstd / CRC-32C library."""
    lib = ctypes.CDLL(str(build_library(SOURCE, LIB_NAME, "zstd")))
    p, i64, s, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int
    lib.gfnet_zstd_decompress.argtypes = [p, i64, p, i64, s, i]
    lib.gfnet_zstd_decompress.restype = i64
    lib.gfnet_zstd_content_size.argtypes = [p, i64]
    lib.gfnet_zstd_content_size.restype = i64
    lib.gfnet_crc32c.argtypes = [p, i64, ctypes.c_uint32]
    lib.gfnet_crc32c.restype = ctypes.c_uint32
    return lib


def _buffer(data) -> tuple[ctypes.c_void_p, int, object]:
    """A pointer to the bytes of `data` (bytes, bytearray, memoryview or a
    contiguous uint8 array), its length, and the object that keeps it alive."""
    arr = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return ctypes.c_void_p(arr.ctypes.data), arr.size, arr


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of `data`, continuing from `crc`."""
    ptr, n, _keep = _buffer(data)
    return load_library().gfnet_crc32c(ptr, n, crc)


def zstd_decompress(data, size: int | None = None, name: str = "<bytes>",
                    max_size: int = _MAX_UNKNOWN_SIZE) -> np.ndarray:
    """Every zstd frame of `data`, decompressed into a uint8 array. `size`,
    when given, is the size the content must have; else the frames' headers
    state it, or the buffer grows up to `max_size`."""
    lib = load_library()
    ptr, n, _keep = _buffer(data)
    known = size is not None
    if not known:
        stated = lib.gfnet_zstd_content_size(ptr, n)
        known = stated >= 0
        size = stated if known else min(max(4 * n, 1 << 16), max_size)
    if size > max_size:
        raise OrbaxFormatError(f"{name}: zstd content of {size} bytes exceeds the limit of {max_size}")
    err = ctypes.create_string_buffer(_ERR_LEN)
    while True:
        out = np.empty(max(size, 1), np.uint8)
        got = lib.gfnet_zstd_decompress(ptr, n, ctypes.c_void_p(out.ctypes.data), size, err, _ERR_LEN)
        if got == -2 and not known and size < max_size:
            size = min(2 * size, max_size)
            continue
        if got < 0:
            raise OrbaxFormatError(f"{name}: zstd: {err.value.decode()}")
        if known and got != size:
            raise OrbaxFormatError(f"{name}: zstd content is {got} bytes, {size} expected")
        return out[:got]


# ------------------------------------------------------------------ OCDBT
class _Reader:
    """Bounds-checked reads of a decoded manifest or node body."""

    def __init__(self, buf: bytes, name: str):
        self.buf, self.pos, self.name = buf, 0, name

    def fail(self, what: str):
        raise OrbaxFormatError(f"{self.name}: {what} at byte {self.pos} of its body")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            self.fail(f"body ends early ({n} bytes wanted)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32le(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64le(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]


def _varint_at(buf: bytes, pos: int, name: str) -> tuple[int, int]:
    r = _Reader(buf, name)
    r.pos = pos
    return r.varint(), r.pos


def _inside(root: Path, rel: str, what: str) -> Path:
    """`root / rel`, refused unless it lies under `root`: an absolute path
    or `..` in a checkpoint must not reach other files of the host."""
    full = (root / rel).resolve()
    if not full.is_relative_to(root.resolve()):
        raise OrbaxFormatError(f"{root}: {what} names {rel!r}, outside the checkpoint directory")
    return full


def _decode_file(buf: bytes, magic: int, name: str, max_size: int) -> bytes:
    """The body of one OCDBT manifest or node: header checked, CRC-32C
    checked, decompressed."""
    if len(buf) < 18:
        raise OrbaxFormatError(f"{name}: {len(buf)} bytes, too short for an OCDBT header")
    got_magic, length = struct.unpack(">I", buf[:4])[0], struct.unpack("<Q", buf[4:12])[0]
    if got_magic != magic:
        raise OrbaxFormatError(f"{name}: magic {got_magic:08x} at byte 0, {magic:08x} expected")
    if length != len(buf):
        raise OrbaxFormatError(f"{name}: header says {length} bytes, the file holds {len(buf)}")
    want = struct.unpack("<I", buf[-4:])[0]
    if crc32c(np.frombuffer(buf, np.uint8, len(buf) - 4)) != want:
        raise OrbaxFormatError(f"{name}: CRC-32C mismatch (checksum at byte {len(buf) - 4})")
    version, pos = _varint_at(buf, 12, name)
    if version != 0:
        raise OrbaxFormatError(f"{name}: OCDBT format version {version}, only 0 is read")
    compression, pos = _varint_at(buf, pos, name)
    body = buf[pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body, name=f"{name} (body at byte {pos})", max_size=max_size).tobytes()
    raise OrbaxFormatError(f"{name}: OCDBT compression {compression} at byte {pos - 1}, "
                           "only 0 (none) and 1 (zstd) are read")


def _data_file_table(r: _Reader, transitive: str) -> list[tuple[str, str]]:
    """The data files a manifest or node refers to, as (base path, relative
    path); the file is `<root>/<base><relative>`. Each base path is the
    `transitive` base of the file that holds the table joined with the
    entry's own, so a node's references are relative to its data file's base."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail(f"data file {i} shares {prefix[i]} bytes with a path of {len(prev)}")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(path):
            r.fail(f"data file {i} has a base path longer than its path")
        out.append((transitive + path[:base_len[i]].decode(), path[base_len[i]:].decode()))
        prev = path
    return out


class Ocdbt:
    """The newest version of an OCDBT store at `root`: its keys, and each
    key's value inline or by reference to a data file."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self._paths: dict[str, Path] = {}  # data file → its checked path
        mpath = self.root / "manifest.ocdbt"
        name = str(mpath)
        if not mpath.is_file():
            raise OrbaxFormatError(f"{name}: no OCDBT manifest")
        r = _Reader(_decode_file(mpath.read_bytes(), MANIFEST_MAGIC, name, 1 << 30), name)
        r.take(16)  # uuid
        kind = r.varint()
        r.varint()  # largest inline value
        self.max_node = r.varint()
        r.u8()  # version tree arity (log2)
        compression = r.varint()
        if compression == 1:
            r.u32le()  # zstd level
        elif compression != 0:
            r.fail(f"config names compression {compression}, only 0 (none) and 1 (zstd) are read")
        if kind != 0:
            r.fail(f"manifest kind {kind} (numbered manifests); only single-file manifests are read")
        files = _data_file_table(r, "")
        n = r.varint()
        gen = r.varints(n)
        height = [r.u8() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # keys, tree bytes, indirect value bytes
        [r.u64le() for _ in range(n)]  # commit times
        if n == 0:
            r.fail("no versions")
        newest = max(range(n), key=lambda i: gen[i])
        self.entries: dict[bytes, tuple] = {}
        if offset[newest] != MISSING:
            if file_id[newest] >= len(files):
                r.fail(f"root refers to data file {file_id[newest]} of {len(files)}")
            self._walk(files[file_id[newest]], offset[newest], length[newest], height[newest], b"")

    def _read_range(self, file: tuple[str, str], offset: int, length: int, what: str) -> bytes:
        path = "".join(file)
        full = self._paths.get(path)
        if full is None:
            full = self._paths[path] = _inside(self.root, path, what)
        if not full.is_file():
            raise OrbaxFormatError(f"{self.root}: {what} refers to the missing data file {path}")
        size = full.stat().st_size
        if offset + length > size:
            raise OrbaxFormatError(f"{full}: {what} at bytes [{offset}, {offset + length}) "
                                   f"lies outside the file's {size}")
        with open(full, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def _walk(self, file: tuple[str, str], offset: int, length: int, height: int,
              prefix: bytes) -> None:
        name = f"{self.root / ''.join(file)} (node at byte {offset})"
        raw = self._read_range(file, offset, length, "a B-tree node")
        r = _Reader(_decode_file(raw, NODE_MAGIC, name, max(self.max_node, 1 << 20)), name)
        if r.u8() != height:
            r.fail(f"node height is not the {height} its parent names")
        files = _data_file_table(r, file[0])
        n = r.varint()
        kprefix = [0] + r.varints(max(n - 1, 0))
        ksuffix = r.varints(n)
        scp = r.varints(n) if height > 0 else None
        keys, prev = [], b""
        for i in range(n):
            if kprefix[i] > len(prev):
                r.fail(f"key {i} shares {kprefix[i]} bytes with a key of {len(prev)}")
            prev = prev[:kprefix[i]] + r.take(ksuffix[i])
            keys.append(prev)

        def file_of(j: int) -> tuple[str, str]:
            if j >= len(files):
                r.fail(f"reference to data file {j} of {len(files)}")
            return files[j]

        if height > 0:
            ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # statistics
            for i in range(n):
                if scp[i] > len(keys[i]):
                    r.fail(f"subtree prefix of {scp[i]} bytes on a key of {len(keys[i])}")
                self._walk(file_of(ids[i]), offs[i], lens[i], height - 1,
                           prefix + keys[i][:scp[i]])
            return
        vlen = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            r.fail(f"value kinds {sorted(set(kinds))}; 0 (inline) and 1 (indirect) are read")
        ids = r.varints(len(indirect))
        offs = r.varints(len(indirect))
        ref = {i: (file_of(j), o) for i, j, o in zip(indirect, ids, offs)}
        for i in range(n):
            key = prefix + keys[i]
            if kinds[i] == 0:
                self.entries[key] = ("inline", r.take(vlen[i]))
            else:
                self.entries[key] = ("ref", ref[i][0], ref[i][1], vlen[i])

    def get(self, key: str) -> bytes | None:
        entry = self.entries.get(key.encode())
        if entry is None:
            return None
        if entry[0] == "inline":
            return entry[1]
        return self._read_range(entry[1], entry[2], entry[3], f"key {key!r}")


class _Files:
    """Keys as files under a directory (`use_ocdbt: false`)."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)

    def get(self, key: str) -> bytes | None:
        path = _inside(self.root, key, "a leaf's key")
        return path.read_bytes() if path.is_file() else None


# ------------------------------------------------------------------- zarr
_ZARR2_DTYPES = {"<f4": "float32", "<f8": "float64", "<f2": "float16", "<i4": "int32",
                 "<i8": "int64", "<u4": "uint32", "|u1": "uint8", "<u1": "uint8",
                 "|b1": "bool", "bfloat16": "bfloat16"}
_ZARR3_DTYPES = {"float32", "float64", "float16", "int32", "int64", "uint32", "uint8", "bool",
                 "bfloat16"}


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _fill(value, dtype: str, where: str):
    if value is None:
        return 0
    if isinstance(value, str):
        special = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}
        if value not in special or dtype in ("bool", "int32", "int64", "uint32", "uint8"):
            raise OrbaxFormatError(f"{where}: fill_value {value!r} is not read")
        return special[value]
    return value


def _out_array(shape, dtype: str, fill) -> np.ndarray:
    if dtype == "bfloat16":
        bits = np.array([fill], np.float32).view(np.uint32) >> 16
        return np.full(shape, bits[0], np.uint16)
    return np.full(shape, fill, _np_dtype(dtype))


def _place(out: np.ndarray, chunk: np.ndarray, idx: tuple[int, ...], chunks) -> None:
    sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, out.shape))
    out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]


def _leaf(out: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        import torch

        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def _chunk_grid(shape, chunks) -> Iterable[tuple[int, ...]]:
    return itertools.product(*[range(-(-s // c)) for s, c in zip(shape, chunks)])


def _read_zarr2(get: Callable[[str], bytes | None], prefix: str, meta: dict, where: str):
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{where}: zarr_format {meta.get('zarr_format')!r}, 2 expected")
    dt = _ZARR2_DTYPES.get(meta.get("dtype"))
    if dt is None:
        raise OrbaxFormatError(f"{where}: dtype {meta.get('dtype')!r} is not read "
                               f"(read: {' '.join(_ZARR2_DTYPES)})")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{where}: compressor {comp.get('id')!r}; zstd or none is read")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{where}: filters {meta['filters']!r} are not read")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise OrbaxFormatError(f"{where}: order {order!r} is not read")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise OrbaxFormatError(f"{where}: dimension_separator {sep!r} is not read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise OrbaxFormatError(f"{where}: chunks {list(chunks)} do not fit shape {list(shape)}")
    npdt = _np_dtype(dt)
    out = _out_array(shape, dt, _fill(meta.get("fill_value"), dt, where))
    nbytes = math.prod(chunks) * npdt.itemsize
    for idx in _chunk_grid(shape, chunks):
        key = f"{prefix}/{sep.join(map(str, idx)) if idx else '0'}"
        raw = get(key)
        if raw is None:
            continue  # a chunk never written holds fill_value
        data = zstd_decompress(raw, nbytes, key) if comp is not None else np.frombuffer(raw, np.uint8)
        if data.size != nbytes:
            raise OrbaxFormatError(f"{key}: chunk of {data.size} bytes, {nbytes} expected")
        chunk = data.view(npdt).reshape(chunks, order=order)
        _place(out, chunk, idx, chunks)
    return _leaf(out, dt)


def _zarr3_bytes_codecs(codecs: list, where: str) -> list:
    """The bytes-to-bytes codecs of a zarr 3 chain `bytes` (little-endian)
    + [zstd | crc32c ...]."""
    if not codecs or codecs[0].get("name") != "bytes":
        raise OrbaxFormatError(f"{where}: codec chain {codecs!r}; 'bytes' first is read")
    endian = (codecs[0].get("configuration") or {}).get("endian", "little")
    if endian != "little":
        raise OrbaxFormatError(f"{where}: {endian}-endian 'bytes' codec is not read")
    rest = codecs[1:]
    for c in rest:
        if c.get("name") not in ("zstd", "crc32c"):
            raise OrbaxFormatError(f"{where}: codec {c.get('name')!r}; zstd and crc32c are read")
    return rest


def _undo_bytes_codecs(raw, codecs: list, key: str):
    for c in reversed(codecs):
        if c["name"] == "crc32c":
            data = np.frombuffer(raw, np.uint8) if not isinstance(raw, np.ndarray) else raw
            if data.size < 4 or crc32c(data[:-4]) != struct.unpack("<I", data[-4:].tobytes())[0]:
                raise OrbaxFormatError(f"{key}: CRC-32C mismatch")
            raw = data[:-4]
        else:
            raw = zstd_decompress(raw, name=key)
    return np.frombuffer(raw, np.uint8) if not isinstance(raw, np.ndarray) else raw


def _decode_zarr3_chunk(raw, codecs: list, chunk_shape, npdt, key: str, put) -> None:
    """Decode one stored chunk; `put(array, inner_index)` receives each
    (inner) chunk it holds."""
    if codecs and codecs[0].get("name") == "sharding_indexed":
        if len(codecs) != 1:
            raise OrbaxFormatError(f"{key}: codecs after 'sharding_indexed' are not read")
        cfg = codecs[0].get("configuration", {})
        inner = tuple(cfg["chunk_shape"])
        inner_codecs = _zarr3_bytes_codecs(cfg.get("codecs", []), key)
        index_codecs = _zarr3_bytes_codecs(cfg.get("index_codecs", []), key)
        if any(c["name"] != "crc32c" for c in index_codecs):
            raise OrbaxFormatError(f"{key}: shard index codecs {index_codecs!r}; crc32c is read")
        counts = [-(-s // c) for s, c in zip(chunk_shape, inner)]
        nidx = math.prod(counts) * 16 + 4 * len(index_codecs)
        data = np.frombuffer(raw, np.uint8) if not isinstance(raw, np.ndarray) else raw
        if data.size < nidx:
            raise OrbaxFormatError(f"{key}: shard of {data.size} bytes, smaller than its index")
        if cfg.get("index_location", "end") != "end":
            raise OrbaxFormatError(f"{key}: shard index at the {cfg['index_location']}; 'end' is read")
        index = _undo_bytes_codecs(data[data.size - nidx:], index_codecs, f"{key} (shard index)")
        index = index.view("<u8").reshape(-1, 2)
        for j, idx in enumerate(itertools.product(*[range(c) for c in counts])):
            off, nb = (int(v) for v in index[j])
            if off == MISSING and nb == MISSING:
                continue
            if off + nb > data.size:
                raise OrbaxFormatError(f"{key}: inner chunk {idx} at [{off}, {off + nb}) lies "
                                       f"outside the shard's {data.size} bytes")
            body = _undo_bytes_codecs(data[off:off + nb], inner_codecs, f"{key} inner {idx}")
            nbytes = math.prod(inner) * npdt.itemsize
            if body.size != nbytes:
                raise OrbaxFormatError(f"{key}: inner chunk {idx} of {body.size} bytes, {nbytes} expected")
            put(body.view(npdt).reshape(inner), idx, inner)
        return
    bcodecs = _zarr3_bytes_codecs(codecs, key)
    body = _undo_bytes_codecs(raw, bcodecs, key)
    nbytes = math.prod(chunk_shape) * npdt.itemsize
    if body.size != nbytes:
        raise OrbaxFormatError(f"{key}: chunk of {body.size} bytes, {nbytes} expected")
    put(body.view(npdt).reshape(chunk_shape), (0,) * len(chunk_shape), chunk_shape)


def _read_zarr3(get: Callable[[str], bytes | None], prefix: str, meta: dict, where: str):
    if meta.get("zarr_format") != 3 or meta.get("node_type", "array") != "array":
        raise OrbaxFormatError(f"{where}: not a zarr 3 array")
    dt = meta.get("data_type")
    if dt not in _ZARR3_DTYPES:
        raise OrbaxFormatError(f"{where}: data_type {dt!r} is not read "
                               f"(read: {' '.join(sorted(_ZARR3_DTYPES))})")
    grid = meta.get("chunk_grid", {})
    if grid.get("name") != "regular":
        raise OrbaxFormatError(f"{where}: chunk grid {grid.get('name')!r}; 'regular' is read")
    enc = meta.get("chunk_key_encoding", {"name": "default"})
    if enc.get("name") != "default":
        raise OrbaxFormatError(f"{where}: chunk key encoding {enc.get('name')!r}; 'default' is read")
    sep = (enc.get("configuration") or {}).get("separator", "/")
    shape = tuple(meta["shape"])
    chunks = tuple(grid["configuration"]["chunk_shape"])
    npdt = _np_dtype(dt)
    out = _out_array(shape, dt, _fill(meta.get("fill_value"), dt, where))
    for idx in _chunk_grid(shape, chunks):
        key = f"{prefix}/{sep.join(['c', *map(str, idx)])}"
        raw = get(key)
        if raw is None:
            continue
        origin = [i * c for i, c in zip(idx, chunks)]

        def put(arr, inner_idx, inner):
            sl = tuple(slice(o + i * c, min(o + (i + 1) * c, s))
                       for o, i, c, s in zip(origin, inner_idx, inner, shape))
            out[sl] = arr[tuple(slice(0, s.stop - s.start) for s in sl)]

        _decode_zarr3_chunk(raw, meta.get("codecs", []), chunks, npdt, key, put)
    return _leaf(out, dt)


def read_array(get: Callable[[str], bytes | None], prefix: str, where: str = ""):
    """The zarr 2 or zarr 3 array stored under `prefix` in a key-value store
    whose values `get(key)` returns (None for a missing key)."""
    where = where or prefix
    raw = get(f"{prefix}/.zarray")
    if raw is not None:
        return _read_zarr2(get, prefix, json.loads(raw), f"{where}/.zarray")
    raw = get(f"{prefix}/zarr.json")
    if raw is not None:
        return _read_zarr3(get, prefix, json.loads(raw), f"{where}/zarr.json")
    raise OrbaxFormatError(f"{where}: no .zarray or zarr.json for this leaf")


# ------------------------------------------------------------- checkpoint
def checkpoint_leaves(path: str | os.PathLike) -> dict[tuple[str, ...], dict]:
    """`_METADATA`'s leaves: tuple path → value metadata (`value_type`,
    `skip_deserialize`, ...), in the file's order."""
    mpath = Path(path) / "_METADATA"
    if not mpath.is_file():
        raise OrbaxFormatError(f"{path}: no _METADATA file; not an orbax checkpoint this module reads")
    meta = json.loads(mpath.read_text())
    if "tree_metadata" not in meta:
        raise OrbaxFormatError(f"{mpath}: no tree_metadata")
    out = {}
    for name, leaf in meta["tree_metadata"].items():
        keys = tuple(str(k["key"]) for k in leaf.get("key_metadata", []))
        if not keys:
            raise OrbaxFormatError(f"{mpath}: leaf {name} has no key_metadata")
        out[keys] = leaf.get("value_metadata", {})
    return out


def read_checkpoint(path: str | os.PathLike) -> dict:
    """The arrays of the orbax checkpoint directory `path`, as dicts nested
    along `_METADATA`'s paths."""
    path = Path(path)
    meta = json.loads((path / "_METADATA").read_text()) if (path / "_METADATA").is_file() else {}
    leaves = checkpoint_leaves(path)
    use_ocdbt = meta.get("use_ocdbt", (path / "manifest.ocdbt").is_file())
    store = Ocdbt(path) if use_ocdbt else _Files(path)
    tree: dict = {}
    for leaf, vmeta in leaves.items():
        if vmeta.get("value_type") == "None" or vmeta.get("skip_deserialize"):
            continue
        arr = read_array(store.get, ".".join(leaf), f"{path}: {'/'.join(leaf)}")
        d = tree
        for k in leaf[:-1]:
            d = d.setdefault(k, {})
        d[leaf[-1]] = arr
    return tree


def flatten(tree: dict, prefix: str = "") -> dict[str, object]:
    """A nested tree → {"/"-joined path: leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        else:
            out[name] = v
    return out
