"""The port's Orbax reader (`utils/orbax.py`, `csrc/zstd.cpp`) and what it
feeds: Orbax heads through `utils/convert.load_head`, and the JAX trainer's
step directories through `train/checkpoint.Checkpointer`'s auto-resume.

zstd against the `zstandard` package; CRC-32C on its standard vector; OCDBT
and zarr on checkpoints that orbax and tensorstore write here; the
committed fixtures of `scripts/make_orbax_fixtures_torch.py` against JAX's
own restore and their `.npz`; the head and the resumed run against the JAX
package on the CPU in float32. An Orbax head through `match()` against the
JAX matcher is in `tests/test_torch_matcher.py`, beside its compiled matcher.
"""

import functools
import json
import os
import shutil
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gfnet_tpu.config import TrainConfig as JTrainConfig
from gfnet_tpu.train.checkpoint import Checkpointer as JCheckpointer
from gfnet_tpu.train.state import create_train_state as j_create_train_state
from gfnet_tpu_torch.config import TrainConfig, tiny_test_config
from gfnet_tpu_torch.models.gfnet import GFNet
from gfnet_tpu_torch.train.checkpoint import Checkpointer
from gfnet_tpu_torch.train.state import create_train_state
from gfnet_tpu_torch.utils import orbax
from gfnet_tpu_torch.utils.convert import (flax_to_torch_head, flax_to_torch_head_moments, load_head,
                                           load_head_npz)
from gfnet_tpu_torch.utils.jax_init import jax_head_params

zstandard = pytest.importorskip("zstandard")
ocp = pytest.importorskip("orbax.checkpoint")

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "data" / "orbax"
TINY_RUN = FIXTURES / "tiny_run" / "tinyset" / "step_000000002"
FLAGSHIP = FIXTURES / "flagship_head"
R5B = REPO / "workspace" / "trained_head_flagship_r5b.npz"
TINY_HEAD = REPO / "workspace" / "trained_head_tiny.npz"
TRAIN_CFG = dict(total_pairs=48, ckpt_every_pairs=24, grad_clip_norm=0.01)  # k = 3 steps at batch 8


# ------------------------------------------------------------------ zstd
def _payloads() -> dict[str, bytes]:
    rng = np.random.default_rng(0)
    text = (REPO / "gfnet_tpu_torch" / "csrc" / "zstd.cpp").read_bytes()
    with np.load(TINY_HEAD) as raw:
        weights = b"".join(np.asarray(raw[k], np.float32).tobytes() for k in sorted(raw.files)
                           if k != "__protocol_kv_norm__")[:400_000]
    base = bytes(rng.integers(0, 200, 20_000, dtype=np.uint8))
    copies = [base] + [base[a:a + n] + b"\xff" for a, n in zip(rng.integers(0, 19_000, 4000),
                                                              rng.integers(8, 40, 4000))]
    words = [rng.bytes(4) for _ in range(64)]
    return {
        "empty": b"",
        "one_byte": b"x",
        "random": rng.bytes(100_000),
        "long_runs": bytes(200_000) + b"a" * 50_000 + bytes(rng.integers(0, 3, 30_000, dtype=np.uint8)),
        "text": text * 4,
        "tiny_head_f32": weights,
        # literals all one byte between copies: RLE literals
        "copies": b"".join(copies),
        # ~5 bytes a sequence: more than 0x7F00 sequences in a block
        "short_matches": b"".join(words[i] + bytes([j]) for i, j in
                                  zip(rng.integers(0, 64, 40_000), rng.integers(0, 256, 40_000))),
    }


PAYLOADS = _payloads()
LEVELS = (-5, 1, 3, 19, 22)


@pytest.mark.parametrize("name", sorted(PAYLOADS))
@pytest.mark.parametrize("level", LEVELS)
def test_zstd_matches_zstandard(level, name):
    data = PAYLOADS[name]
    for checksum in (False, True):
        frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
        assert orbax.zstd_decompress(frame).tobytes() == data
        assert orbax.zstd_decompress(frame, len(data)).tobytes() == data


@pytest.mark.parametrize("level", LEVELS)
def test_zstd_payload_larger_than_the_window(level):
    """A 1 KiB window over 200 KB: matches reach only back into the window,
    the frame is not single-segment and its blocks stop at the window."""
    data = (PAYLOADS["text"] * 8)[:200_000]
    params = zstandard.ZstdCompressionParameters.from_level(level, window_log=10)
    frame = zstandard.ZstdCompressor(compression_params=params).compress(data)
    assert not frame[4] & 0x20  # no single-segment flag: a window descriptor follows
    assert orbax.zstd_decompress(frame).tobytes() == data


def test_zstd_frames_back_to_back_skippable_and_unsized():
    a, b = PAYLOADS["text"], PAYLOADS["tiny_head_f32"]
    frames = (zstandard.ZstdCompressor(level=3).compress(a)
              + (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
              + zstandard.ZstdCompressor(level=19, write_checksum=True).compress(b))
    assert orbax.zstd_decompress(frames).tobytes() == a + b
    stream = zstandard.ZstdCompressor(level=5).compressobj()
    unsized = stream.compress(a * 30) + stream.flush()  # no content size in the header
    assert orbax.load_library().gfnet_zstd_content_size(unsized, len(unsized)) == -1
    assert orbax.zstd_decompress(unsized).tobytes() == a * 30


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=3000), level=st.integers(-7, 19), checksum=st.booleans())
def test_zstd_round_trip_property(data, level, checksum):
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert orbax.zstd_decompress(frame).tobytes() == data


def test_zstd_corrupt_or_truncated_input_raises():
    data = PAYLOADS["text"]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    rng = np.random.default_rng(1)
    raised = 0
    for pos, bit in zip(rng.integers(0, len(frame), 1500), rng.integers(0, 8, 1500)):
        bad = bytearray(frame)
        bad[pos] ^= 1 << bit
        try:
            out = orbax.zstd_decompress(bytes(bad), len(data))
        except orbax.OrbaxFormatError as e:
            assert "zstd" in str(e)
            raised += 1
        else:  # a flip the format does not read (a padding bit) leaves the content as it was
            assert out.tobytes() == data
    assert raised > 1400
    for cut in (0, 3, 4, 6, 12, len(frame) // 2, len(frame) - 1):
        with pytest.raises(orbax.OrbaxFormatError, match="at byte"):
            orbax.zstd_decompress(frame[:cut], len(data))
    with pytest.raises(orbax.OrbaxFormatError, match="larger than the buffer"):
        orbax.zstd_decompress(frame, 100)
    with pytest.raises(orbax.OrbaxFormatError, match="exceeds the limit"):
        orbax.zstd_decompress(frame, max_size=100)
    dict_frame = bytearray(frame)
    dict_frame[4] |= 1  # a one-byte dictionary id follows
    dict_frame.insert(5, 7)
    with pytest.raises(orbax.OrbaxFormatError, match="dictionary"):
        orbax.zstd_decompress(bytes(dict_frame))


def test_crc32c_standard_vector():
    assert orbax.crc32c(b"123456789") == 0xE3069283
    assert orbax.crc32c(b"") == 0
    assert orbax.crc32c(b"56789", orbax.crc32c(b"1234")) == 0xE3069283


# ------------------------------------------------------ OCDBT and zarr
def _tree(rng) -> dict:
    return {"params": {"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
                       "big": rng.normal(0, 1, (400, 700)).astype(np.float32),  # 1.1 MB
                       "b": jnp.asarray(rng.normal(0, 1, (5,)), jnp.bfloat16),
                       "i": rng.integers(-9, 9, (2, 3)).astype(np.int32)},
            "step": np.asarray(7, np.int32), "scale": np.asarray(2.5, np.float32),
            "flag": np.array([True, False]), "empty": None}


def _flat_ref(tree, prefix: str = "") -> dict:
    """orbax's restore → {"/"-joined path: leaf}; lists and tuples by position."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat_ref(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _same(mine, ref) -> None:
    for k, v in _flat_ref(ref).items():
        if v is None:
            continue
        got = mine
        for part in k.split("/"):
            got = got[part]
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.bfloat16
            got = got.view(torch.int16).numpy()
            v = np.asarray(v).view(np.int16)
        v = np.asarray(v)
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert got.tobytes() == v.tobytes(), k


@pytest.mark.parametrize("layout", ["ocdbt", "files", "zarr3"])
def test_live_round_trip_bit_for_bit(tmp_path, layout):
    tree = _tree(np.random.default_rng(0))
    path = tmp_path / "ckpt"
    handler = {"ocdbt": ocp.PyTreeCheckpointHandler(),
               "files": ocp.PyTreeCheckpointHandler(use_ocdbt=False),
               "zarr3": ocp.PyTreeCheckpointHandler(use_zarr3=True)}[layout]
    ocp.Checkpointer(handler).save(path, args=ocp.args.PyTreeSave(tree))
    meta = json.loads((path / "_METADATA").read_text())
    assert meta["use_ocdbt"] == (layout != "files") and meta["use_zarr3"] == (layout == "zarr3")
    got = orbax.read_checkpoint(path)
    assert "empty" not in got  # value_type None
    _same(got, tree)
    assert sorted(orbax.flatten(got)) == sorted(k for k, v in _flat_ref(tree).items() if v is not None)


def test_ocdbt_interior_nodes_and_indirect_values(tmp_path):
    """A store written by tensorstore with 512-byte nodes (a B+tree of
    height > 0, prefix-compressed keys on every level) and values over 100
    bytes kept out of line."""
    ts = pytest.importorskip("tensorstore")
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_decoded_node_bytes": 512, "max_inline_value_bytes": 100}}
    kv = ts.KvStore.open(spec).result()
    want = {f"key/{i:05d}/x": bytes([i % 256]) * (10 + i) for i in range(200)}
    with ts.Transaction() as txn:
        for k, v in want.items():
            kv.with_transaction(txn).write(k, v).result()
    store = orbax.Ocdbt(tmp_path)
    assert sorted(k.decode() for k in store.entries) == sorted(want)
    assert {k: store.get(k) for k in want} == want
    assert any(e[0] == "ref" for e in store.entries.values())
    assert store.get("key/missing") is None


@pytest.mark.parametrize("order,sep,compressor", [("C", ".", {"id": "zstd", "level": 3}),
                                                 ("F", "/", None)])
def test_zarr2_chunked_arrays_with_a_missing_chunk(tmp_path, order, sep, compressor):
    """zarr 2 as tensorstore writes it beyond what orbax does: (5, 7) in
    (2, 3) chunks, either dimension separator and order, a chunk never
    written (it reads as fill_value)."""
    ts = pytest.importorskip("tensorstore")
    want = np.arange(35, dtype=np.float32).reshape(5, 7) - 17.5
    meta = {"shape": [5, 7], "chunks": [2, 3], "dtype": "<f4", "order": order,
            "dimension_separator": sep, "compressor": compressor, "fill_value": 1.5}
    arr = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/arr", "metadata": meta},
                  create=True).result()
    arr[:, :6].write(want[:, :6]).result()  # chunk column 2 (column 6) stays unwritten
    assert not (tmp_path / "arr" / f"0{sep}2").exists()
    store = orbax._Files(tmp_path)
    got = orbax.read_array(store.get, "arr")
    want[:, 6] = 1.5
    assert got.dtype == np.float32 and got.tobytes() == np.ascontiguousarray(want).tobytes()
    bad = json.loads((tmp_path / "arr" / ".zarray").read_text())
    bad["filters"] = [{"id": "delta", "dtype": "<f4"}]
    (tmp_path / "arr" / ".zarray").write_text(json.dumps(bad))
    with pytest.raises(orbax.OrbaxFormatError, match="filters"):
        orbax.read_array(store.get, "arr")


def test_ocdbt_flipped_byte_raises_with_the_file(tmp_path):
    tree = _tree(np.random.default_rng(1))
    path = tmp_path / "ckpt"
    ocp.PyTreeCheckpointer().save(path, tree)
    node = next((path / "d").iterdir())
    raw = bytearray(node.read_bytes())
    raw[len(raw) // 2] ^= 0x10
    node.write_bytes(bytes(raw))
    with pytest.raises(orbax.OrbaxFormatError, match="CRC-32C") as e:
        orbax.read_checkpoint(path)
    assert node.name in str(e.value)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n >> 7 else 0))
        n >>= 7
        if not n:
            return bytes(out)


def _manifest_naming(data_file: str) -> bytes:
    """A single-file OCDBT manifest, body uncompressed, whose one version's
    root node lies in `data_file` at bytes [0, 64)."""
    path = data_file.encode()
    body = (bytes(16) + _varint(0) + _varint(100) + _varint(1 << 20) + bytes([4]) + _varint(0)
            + _varint(1) + _varint(len(path)) + _varint(0) + path  # one data file, empty base path
            + _varint(1) + _varint(1) + bytes([0]) + _varint(0) + _varint(0) + _varint(64)
            + _varint(0) * 3 + bytes(8))  # generation 1, height 0, file 0, [0, 64), statistics, time
    raw = struct.pack(">IQ", orbax.MANIFEST_MAGIC, 4 + 8 + 2 + len(body) + 4)
    raw = raw[:4] + raw[4:][::-1] + _varint(0) + _varint(0) + body  # length little-endian
    return raw + struct.pack("<I", orbax.crc32c(raw))


@pytest.mark.parametrize("store", ["ocdbt", "files"])
@pytest.mark.parametrize("where", ["dotdot", "absolute"])
def test_a_path_out_of_the_checkpoint_raises(tmp_path, store, where):
    """A data file in the manifest's table, or a leaf key of `_METADATA`,
    that names `../` or an absolute path is refused before anything is read
    there, though the file it names exists and would decode."""
    root = tmp_path / "ckpt"
    root.mkdir()
    outside = tmp_path / "outside"
    outside.mkdir()
    (outside / ".zarray").write_text(json.dumps(
        {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f4", "compressor": None,
         "filters": None, "order": "C", "fill_value": None}))
    (outside / "0").write_bytes(np.arange(2, dtype=np.float32).tobytes())
    (outside / "node").write_bytes(bytes(64))
    name = {"dotdot": "../outside", "absolute": str(outside)}[where]
    if store == "ocdbt":
        (root / "manifest.ocdbt").write_bytes(_manifest_naming(f"{name}/node"))
    leaf = {"key_metadata": [{"key": name, "key_type": 2}], "value_metadata": {"value_type": "np.ndarray"}}
    (root / "_METADATA").write_text(json.dumps({"tree_metadata": {"('x',)": leaf},
                                                "use_ocdbt": store == "ocdbt", "use_zarr3": False}))
    assert orbax.read_array(orbax._Files(outside).get, ".").tolist() == [0.0, 1.0]
    with pytest.raises(orbax.OrbaxFormatError, match="outside the checkpoint directory") as e:
        orbax.read_checkpoint(root)
    assert repr(f"{name}/node" if store == "ocdbt" else f"{name}/.zarray") in str(e.value)


# ---------------------------------------------------------- fixtures
def test_fixtures_equal_jax_restore_and_their_npz():
    got = orbax.read_checkpoint(TINY_RUN)
    with np.load(FIXTURES / "tiny_run.npz") as raw:
        want = {k[len("leaf/"):]: raw[k] for k in raw.files if k.startswith("leaf/")}
    flat = orbax.flatten(got)
    assert sorted(flat) == sorted(want) and len(flat) == 544
    for k, v in want.items():
        assert flat[k].dtype == v.dtype and flat[k].tobytes() == v.tobytes(), k
    _same(got, ocp.PyTreeCheckpointer().restore(TINY_RUN))
    head = orbax.read_checkpoint(FLAGSHIP)
    _same(head, ocp.StandardCheckpointer().restore(FLAGSHIP))
    with np.load(R5B) as raw:
        flat = orbax.flatten(head)
        assert sorted(flat) == sorted(k for k in raw.files if k != "__protocol_kv_norm__")
        for k, v in flat.items():
            assert v.tobytes() == raw[k].tobytes(), k


def test_load_head_reads_the_flagship_fixture_as_its_npz():
    sd, kv_norm = load_head(str(FLAGSHIP))
    want, want_kv = load_head_npz(str(R5B))
    assert kv_norm is None and want_kv is True  # an Orbax head says nothing of k/v norm
    assert sorted(sd) == sorted(want)
    for k in want:
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], want[k]), k


def test_both_packages_refuse_a_trainer_step_directory_as_a_head():
    from gfnet_tpu.utils.convert import load_head_checkpoint

    with pytest.raises(ValueError, match="auto-resume|Checkpointer"):
        load_head(str(TINY_RUN))
    template = jax.tree_util.tree_map(jnp.asarray, _head_params(0))
    with pytest.raises(ValueError, match="opt_state"):
        load_head_checkpoint(str(TINY_RUN), template)


# ------------------------------------------------------------- resume
# one optax update of a JAX TrainState, jitted: eager, its first call compiles op by op (~30 s)
_j_step = jax.jit(lambda state, grads: state.apply_gradients(grads, state.batch_stats))


def _fed(rng, params, norm):
    leaves, treedef = jax.tree_util.tree_flatten(params)
    g = [rng.normal(0, 1, np.shape(x)).astype(np.float32) for x in leaves]
    total = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g))
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x * (norm / total)) for x in g])


@functools.lru_cache(maxsize=2)
def _head_params(seed: int) -> dict:
    return jax_head_params(tiny_test_config(), seed)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_state(cfg: dict):
    head = GFNet(tiny_test_config(), dtype=torch.float32)
    head.load_state_dict(flax_to_torch_head(_head_params(1)))
    return create_train_state(head, TrainConfig(**cfg), 8)


def _port_update(state, grads: dict, stats: dict) -> None:
    """One update of the port from a JAX gradient tree, laid out by the bridge."""
    g = flax_to_torch_head_moments(_np_tree(grads), _np_tree(stats))
    for name, p in state.head.named_parameters():
        p.grad = g[name].clone()
    state.apply_gradients()


def _assert_params_equal(state, params, stats, **tol) -> None:
    want = flax_to_torch_head({"params": _np_tree(params), "batch_stats": _np_tree(stats)})
    got = state.head.state_dict()
    for name, _ in state.head.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), err_msg=name, **tol)


def test_resume_jax_run_across_a_schedule_chunk(tmp_path):
    """JAX trains 4 fed steps (k = 3: the schedule steps after the third)
    and checkpoints; the port resumes it and takes the 5th with JAX."""
    rng = np.random.default_rng(4)
    head_vars = jax.tree_util.tree_map(jnp.asarray, _head_params(0))
    jstate = j_create_train_state(head_vars, JTrainConfig(**TRAIN_CFG), 8)
    for norm in (0.004, 0.03, 0.002, 0.05):
        jstate = _j_step(jstate, _fed(rng, jstate.params, norm))
    JCheckpointer(str(tmp_path), "run").save(jstate)
    state = _port_state(TRAIN_CFG)
    ck = Checkpointer(str(tmp_path), "run")
    assert ck.latest_path.endswith("step_000000004")
    assert ck.restore(state) is state and state.step == 4
    _assert_params_equal(state, jstate.params, jstate.batch_stats, rtol=0, atol=0)
    last = _fed(rng, jstate.params, 0.02)
    jnext = _j_step(jstate, last)
    _port_update(state, last, jstate.batch_stats)
    assert state.step == 5
    _assert_params_equal(state, jnext.params, jstate.batch_stats, rtol=1e-6, atol=1e-7)
    # the update moved the parameters by more than the tolerance
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(jnext.params),
                                jax.tree_util.tree_leaves(jstate.params)))
    assert moved > 1e-5


def test_resume_the_committed_tiny_run(tmp_path):
    """The fixture's step 2, restored, then its third fed update: JAX's
    stored parameters; with the AdamW count off by one it reads far off."""
    shutil.copytree(TINY_RUN.parent, tmp_path / "tinyset")
    with np.load(FIXTURES / "tiny_run.npz") as f:
        raw = {k: f[k] for k in f.files}
    cfg = {k: raw[f"config/{k}"].item() for k in ("total_pairs", "ckpt_every_pairs", "grad_clip_norm")}

    def sub(prefix: str) -> dict:
        tree: dict = {}
        for k, v in raw.items():
            if k.startswith(prefix):
                d = tree
                *parents, leaf = k[len(prefix):].split("/")
                for p in parents:
                    d = d.setdefault(p, {})
                d[leaf] = v
        return tree

    stats = sub("leaf/batch_stats/")
    grad3, params3 = sub("grad3/"), sub("params3/")
    for off in (0, 1):
        state = _port_state(cfg)
        Checkpointer(str(tmp_path), "tinyset").restore(state)
        assert state.step == int(raw["leaf/step"]) == 2
        for s in state.optimizer.state.values():
            s["step"] += off
        _port_update(state, grad3, stats)
        if off == 0:
            _assert_params_equal(state, params3, stats, rtol=1e-6, atol=1e-7)
        else:
            with pytest.raises(AssertionError):
                _assert_params_equal(state, params3, stats, rtol=1e-6, atol=1e-7)


def test_schedule_count_must_equal_step(tmp_path):
    head_vars = jax.tree_util.tree_map(jnp.asarray, _head_params(0))
    jstate = j_create_train_state(head_vars, JTrainConfig(**TRAIN_CFG), 8)
    JCheckpointer(str(tmp_path), "run").save(jstate.replace(step=jstate.step + 3))
    with pytest.raises(ValueError, match=r"opt_state/1/2/count = 0 differs from step = 3"):
        Checkpointer(str(tmp_path), "run").restore(_port_state(TRAIN_CFG))


def test_latest_path_across_pt_orbax_and_legacy(tmp_path):
    ck = Checkpointer(str(tmp_path), "exp")
    d = Path(ck.dir)
    assert ck.latest_path is None
    (d / "latest").mkdir()
    assert ck.latest_path == str(d / "latest")
    (d / "step_000000003.pt").write_bytes(b"")
    assert ck.latest_path == str(d / "step_000000003.pt")
    (d / "step_000000005").mkdir()
    assert ck.latest_path == str(d / "step_000000005")
    (d / "step_000000005.pt").write_bytes(b"")
    assert ck.latest_path == str(d / "step_000000005.pt")  # a tie goes to the port's own file
    (d / "step_000000009").write_bytes(b"")  # a file named like a directory is neither
    (d / "step_000000007.pt").mkdir()
    assert ck.latest_path == str(d / "step_000000005.pt")
    # saves stay .pt and pruning never touches a JAX directory
    state = _port_state(TRAIN_CFG)
    for step in (10, 11, 12):
        state.step = step
        ck.save(state)
    assert sorted(os.listdir(d)) == ["latest", "step_000000005", "step_000000007.pt",
                                     "step_000000009", "step_000000011.pt", "step_000000012.pt"]
