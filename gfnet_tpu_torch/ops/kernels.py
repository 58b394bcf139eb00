"""Build, load and launch the hand-written CUDA kernels.

The sources under `gfnet_tpu_torch/csrc/` (K1 attention, K2 local correlation,
K3, its gradient in the query, K4, the sampler's kernel density estimate, and
K5, the ViT block's residual stream) compile at first use into one shared
library with a plain C interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c <src>.cu
    nvcc -shared -o libgfnet_kernels.so *.o

one `nvcc` per source, all started together, so the build takes as long as
its slowest source however many kernels later slices add. The library lands in
`gfnet_tpu_torch/_build/<hash of sources and flags>/`, so an edited source
rebuilds and an unchanged one loads at once.

Each wrapper checks device, dtype, shape and layout, allocates its output
(and K1 its kv splits' workspace) with `torch.empty`, launches on the
current stream of the tensors' device (which the library makes current in
the calling thread: autograd runs backward on threads of its own), raises
if the launch failed, and counts the launch in the recorder of
`utils/profiling.py` (`k1.launches`, `k2.launches`, `k3.launches`,
`k4.launches`, `k5.launches`; `launch_counts()` reads them). Nothing here
falls back to a plain PyTorch version: the callers in `ops/attention.py`,
`ops/local_correlation.py`, `ops/kde.py` and `ops/residual_norm.py` take the
plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from gfnet_tpu_torch.utils import profiling

Tensor = torch.Tensor

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("oneshot_attention.cu", "local_corr.cu", "local_corr_bwd.cu", "kde.cu", "residual_norm.cu")
HEADERS = ("local_corr_window.cuh",)  # included by the sources; hashed with them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libgfnet_kernels.so"

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path, sources: tuple[str, ...] = SOURCES, flags: tuple[str, ...] = ()) -> None:
    """One `nvcc` per source, all started together, then one link. The
    library is linked under a name of this process and renamed into place,
    so a concurrent loader never sees a half-written file. `flags` are
    added to `NVCC_FLAGS` (a variant's `-D`)."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    objs = [out_dir / f"{Path(name).stem}.{os.getpid()}.o" for name in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-c", str(CSRC / name), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, obj in zip(sources, objs)]
    outs = [proc.communicate()[0] for proc in procs]
    for name, proc, out in zip(sources, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
    lib = out_dir / f"{LIB_NAME}.{os.getpid()}"
    link = subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (out_dir / "build.log").write_text("\n".join(f"== {n}\n{o}" for n, o in zip(sources, outs)))
    os.replace(lib, out_dir / LIB_NAME)


def declare_attention(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.gfnet_oneshot_attention.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, ll, ll, ll, ll, ll, ll, f, i, i, i, p,
                                            ctypes.POINTER(i)]
    lib.gfnet_oneshot_attention.restype = i
    lib.gfnet_oneshot_attention_kernel_name.argtypes = [i]
    lib.gfnet_oneshot_attention_kernel_name.restype = ctypes.c_char_p


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    declare_attention(lib)
    corr = [i, p, p, p, p] + [i] * 16 + [f, i, p]
    lib.gfnet_local_corr.argtypes = corr
    lib.gfnet_local_corr.restype = i
    lib.gfnet_local_corr_bwd.argtypes = corr
    lib.gfnet_local_corr_bwd.restype = i
    lib.gfnet_kde.argtypes = [i, p, p, p, i, i, f, p]
    lib.gfnet_kde.restype = i
    lib.gfnet_residual_norm.argtypes = [i, p, p, p, p, p, p, p, ll, i, f, i, p]
    lib.gfnet_residual_norm.restype = i


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; records the build time
    and the compiler's register/shared-memory report in `build_info`."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = BUILD_ROOT / _source_hash()
    t0 = time.perf_counter()
    built = not (out_dir / LIB_NAME).exists()
    if built:
        _build(out_dir)
    lib = ctypes.CDLL(str(out_dir / LIB_NAME))
    _declare(lib)
    build_info.update(path=str(out_dir / LIB_NAME), built=built,
                      seconds=time.perf_counter() - t0,
                      log=(out_dir / "build.log").read_text() if (out_dir / "build.log").exists() else "")
    _lib = lib
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError {err}")


def _require_cuda(name: str, *tensors: Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# the head dims K1 is instantiated at; any other up to 256 runs on
# zero-padded copies, one above 256 on the wide kernels at a multiple of 64
# (`attention_head_dim`, `attention_value_dim`, `pad_head_dim`)
ATTENTION_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
ATTENTION_BOX = 64         # above 256: q/k channels and bf16 v columns come in boxes of 64
ATTENTION_SLAB = 512       # above 256, bf16: the most v columns one block takes (two warpgroups' 256)
ATTENTION_F32_GROUP = 256  # above 256, float32: the v columns one block takes (a column group)
KV_TILE = 64  # keys: a kv split is a multiple of it


def attention_head_dim(d: int) -> int:
    """The width at which K1 computes the logits of head dim `d`: the smallest
    of `ATTENTION_HEAD_DIMS` that holds it, and above 256 `d` rounded up to a
    multiple of `ATTENTION_BOX` (the wide kernels read q and k in boxes or
    k-steps of 64 channels). Any `d` runs."""
    if d < 1:
        raise ValueError(f"oneshot_attention: head dim {d}")
    for width in ATTENTION_HEAD_DIMS:
        if d <= width:
            return width
    return -(-d // ATTENTION_BOX) * ATTENTION_BOX


def attention_value_dim(d: int, bf16: bool) -> int:
    """The width of v and of K1's output for head dim `d`: the logits' width
    up to 256, and above it in bf16 too (the wide kernel's warpgroups take
    whole 64-column boxes of v); above 256 in float32, whole column groups of
    `ATTENTION_F32_GROUP`."""
    if d <= ATTENTION_HEAD_DIMS[-1] or bf16:
        return attention_head_dim(d)
    return -(-d // ATTENTION_F32_GROUP) * ATTENTION_F32_GROUP


def pad_head_dim(fn, q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """`fn(q, k, v, scale)` on q and k zero-padded along the head dim to
    `attention_head_dim`, v to `attention_value_dim` of q's dtype, sliced back
    to D channels (contiguous). Zero channels in q and k add nothing to a
    logit and those of v give zero outputs, so the function is unchanged;
    `scale` is the caller's, from the unpadded D. A head dim K1 is
    instantiated at passes through as it is."""
    d = q.shape[-1]
    dk, dv = attention_head_dim(d), attention_value_dim(d, q.dtype == torch.bfloat16)
    if dk == d and dv == d:
        return fn(q, k, v, scale)
    pad = lambda t, width: torch.nn.functional.pad(t, (0, width - d))
    return fn(pad(q, dk), pad(k, dk), pad(v, dv), scale)[..., :d].contiguous()


@functools.lru_cache(maxsize=512)
def attention_splits(bf16: bool, b: int, nq: int, nk: int, h: int, dk: int, dv: int,
                     sms: int) -> tuple[int, int]:
    """(splits, keys a split) of a K1 launch. Where the kernel's blocks (q
    rows × batch·heads × column groups or slabs) are fewer than the card's
    `sms` times the blocks an SM holds (two of the float32 kernel's four
    warps, one of a bf16 kernel's eight), the kv range is split into ranges
    of whole 64-key tiles, at least two tiles each, as many as that many
    blocks hold; a second kernel merges the splits. Else one split of the
    whole range. Cached: a launch's host cost."""
    tiles = -(-nk // KV_TILE)
    rows = 64 if (not bf16 or dk >= 256) else 128
    groups = 1
    if dk > 256:
        groups = -(-dv // ATTENTION_SLAB) if bf16 else dv // ATTENTION_F32_GROUP
    blocks = -(-nq // rows) * b * h * groups
    splits = min(sms * (1 if bf16 else 2) // blocks, tiles // 2)
    if splits < 2:
        return 1, tiles * KV_TILE
    per = -(-tiles // splits) * KV_TILE
    return -(-nk // per), per


@functools.lru_cache(maxsize=512)
def _attention_plan(bf16: bool, b: int, nq: int, nk: int, h: int, d: int, index: int) -> tuple[int, int, int, int]:
    """(dk, dv, splits, keys a split) of a K1 call on device `index`, cached:
    the launches are many and short, and bound by the host."""
    dk, dv = attention_head_dim(d), attention_value_dim(d, bf16)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return (dk, dv) + attention_splits(bf16, b, nq, nk, h, dk, dv, sms)


def oneshot_attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """K1: softmax(q·kᵀ·scale)·v over (B, N, H, D) CUDA tensors → contiguous
    (B, Nq, H, D), float32 or bf16, any D. The kernels are instantiated at D
    in `ATTENTION_HEAD_DIMS`; another D up to 256 runs them on copies
    zero-padded to the next of those. Above 256, q and k are padded to a
    multiple of 64 channels; bf16 runs the wide kernel, whose blocks stream
    q, k and v through shared memory in 64 x 64 boxes by TMA, compute the
    logits once on `wgmma` and give them to up to 512 output columns (two
    warpgroups), v padded to a multiple of 64 only; float32 runs column
    groups of 256 output columns (v padded to whole groups), each block
    computing the logits over the whole D: `pad_head_dim`, one call,
    counted as one (the counter `k1.kernel.<name>` counts the calls by the
    CUDA kernel the library reports it launched). At an instantiated
    D the head and channel dims must be packed (strides D, 1), the batch
    and token strides are free (a slice of a fused qkv projection is read in
    place). Both types run on tensor cores (bf16: `wgmma` at D = 64, 128,
    256 and above, `mma.sync` at 8, 16, 32; float32: `mma.sync` TF32 in three
    passes, float32 precision) and read 16-byte vectors: pointers must be
    16-byte aligned and batch and token strides whole 16-byte vectors, and a
    bf16 scale positive, or it raises. Where the blocks would not fill the
    card the kv range is split (`attention_splits`): a second launch merges
    the splits, still one call."""
    _require_cuda("oneshot_attention", q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"oneshot_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"oneshot_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, nq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"oneshot_attention: q {tuple(q.shape)} vs kv {tuple(k.shape)}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and not scale > 0:
        raise ValueError(f"oneshot_attention: bf16 needs a positive scale, got {scale}")
    dk, dv, splits, kv_split = _attention_plan(bf16, b, nq, k.shape[1], h, d, q.device.index)
    if dk == d and dv == d:
        return _attention_launch(q, k, v, scale, splits, kv_split)
    return pad_head_dim(functools.partial(_attention_launch, splits=splits, kv_split=kv_split), q, k, v, scale)


def _attention_launch(q: Tensor, k: Tensor, v: Tensor, scale: float, splits: int, kv_split: int,
                      lib: ctypes.CDLL | None = None) -> Tensor:
    """One K1 call at the kernels' widths: q, k (..., dk), v (..., dv), the
    kv range in `splits` ranges of `kv_split` keys; `lib` another build of
    the attention source (a timing variant), by default the package's."""
    b, nq, h, dk = q.shape
    dv = v.shape[3]
    bf16 = q.dtype == torch.bfloat16
    vec = 16 // q.element_size()
    for t, width in ((q, dk), (k, dk), (v, dv)):
        if t.stride(3) != 1 or t.stride(2) != width:
            raise ValueError("oneshot_attention: head and channel dims must be packed")
        if t.data_ptr() % 16 or t.stride(0) % vec or t.stride(1) % vec:
            raise ValueError("oneshot_attention: needs 16-byte aligned pointers and batch/token "
                             f"strides that are multiples of {vec} elements")
    nk = k.shape[1]
    out = torch.empty((b, nq, h, dv), dtype=q.dtype, device=q.device)
    work = (torch.empty(splits * b * h * nq * (dv + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    lib = load_library() if lib is None else lib
    kernel = ctypes.c_int(-1)  # the library's index of the kernel it launched
    err = lib.gfnet_oneshot_attention(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), b, nq, nk, h, dk, dv, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), float(scale), int(bf16), splits, kv_split,
        _stream(q.device), ctypes.byref(kernel))
    _check(err, "oneshot_attention")
    profiling.count("k1.launches")
    if splits > 1:  # the merge kernel ran too
        profiling.count("k1.merges")
    counter = _K1_COUNTERS.get(kernel.value) or _K1_COUNTERS.setdefault(
        kernel.value, K1_KERNEL + lib.gfnet_oneshot_attention_kernel_name(kernel.value).decode())
    profiling.count(counter)
    return out


K1_KERNEL = "k1.kernel."  # + the name of the CUDA kernel a K1 call launched: its counter
_K1_COUNTERS: dict[int, str] = {}  # the library's index of a K1 kernel → its counter


# The tiling of K2 and K3 (`csrc/local_corr_window.cuh`): a block of eight
# warps owns `tile` cells of one image and stages the union of their windows
# in a box of target pixels, one chunk of channels at a time, where the union
# fits the box.
CORR_TILES = ((8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))  # (rows, columns) of cells
CORR_SMEM_BUDGET = 72 * 1024  # dynamic shared memory of a block: three blocks an SM
CORR_MIN_BLOCKS = 256         # about two blocks for each of the H100's 132 SMs
CORR_WARP_PIXELS = 256        # patch pixels a warp walks at most: one r7 cell
CORR_SCALE_MARGIN = 1.5       # the local scale of the flow a box allows for, against identity


@dataclasses.dataclass(frozen=True)
class CorrSchedule:
    tile: tuple[int, int]  # cells a block owns, (rows, columns)
    box: tuple[int, int]   # target pixels a block may stage, (rows, columns)
    chunk: int             # channels per stage
    # byte offsets into the block's dynamic shared memory of the cells' area,
    # the query rows and the pixel table, and its size
    smem: tuple[int, int, int, int]


def corr_layout(radius: int, channels: int, elem: int, tile: tuple[int, int], box: tuple[int, int],
                chunk: int, query_rows: bool) -> CorrSchedule:
    """A K2/K3 schedule with its block's dynamic shared memory laid out. The
    layout is made here alone and handed to the kernels: the box of one chunk
    at 0, then (2r+2)² floats for each cell (K2's patch dots, K3's spread
    gradient), then the cells' query rows (K2 only: `query_rows`), then the
    table of (2r+2)² patch pixels, each area aligned to 128 bytes, and 128
    bytes of slack that align the base."""
    a = lambda x: (x + 127) // 128 * 128
    win2, cells = (2 * radius + 2) ** 2, tile[0] * tile[1]
    cell_area = a(box[0] * box[1] * chunk * elem)
    query = cell_area + a(cells * win2 * 4)
    table = query + (a(cells * channels * elem) if query_rows else 0)
    return CorrSchedule(tuple(tile), tuple(box), chunk, (cell_area, query, table, table + a(win2 * 4) + 128))


def corr_box(radius: int, tile: tuple[int, int], spacing: tuple[float, float]) -> tuple[int, int]:
    """The box for a tile of cells `spacing` target pixels apart (rows,
    columns): one window, plus the tile's extent at up to 1.5 times the
    identity's scale, plus 2 pixels for the floor and half-pixel jitter."""
    win = 2 * radius + 2
    return tuple(min(256, win + math.ceil(CORR_SCALE_MARGIN * (n - 1) * s) + 2)
                 for n, s in zip(tile, spacing))


@functools.lru_cache(maxsize=256)
def corr_schedule(radius: int, channels: int, elem: int, height: int, width: int,
                  g1: int, g2: int, batch: int, query_rows: bool) -> CorrSchedule:
    """Tile, box, chunk and layout of a K2 (`query_rows`) or K3 launch. The
    chunk is the largest run of channels up to 128 bytes (eight 16-byte
    vectors, a power of two of them) that divides a pixel; the tile is the
    largest of `CORR_TILES` that gives a warp at most `CORR_WARP_PIXELS` patch
    pixels (a warp's cells run one after another), whose grid has at least
    `CORR_MIN_BLOCKS` blocks (else the smallest) and whose block fits
    `CORR_SMEM_BUDGET`; where none fits, the chunk halves. Raises where the
    target cannot be staged by TMA: a pixel that is not a multiple of 16
    bytes, or a window that no box holds. Cached: a launch's host cost."""
    if channels * elem % 16:
        raise ValueError(f"local correlation: a target pixel of {channels} channels × {elem} bytes "
                         "is not a multiple of 16 bytes, which TMA and the 16-byte loads need")
    nv = channels * elem // 16
    lanes = 8
    while nv % lanes:
        lanes //= 2
    spacing = (height / g1, width / g2)
    while lanes >= 1:
        chunk = lanes * 16 // elem
        for tile in CORR_TILES:
            blocks = batch * -(-g1 // tile[0]) * -(-g2 // tile[1])
            small = tile[0] * tile[1] * (2 * radius + 2) ** 2 <= 8 * CORR_WARP_PIXELS
            if (blocks < CORR_MIN_BLOCKS or not small) and tile != CORR_TILES[-1]:
                continue
            sched = corr_layout(radius, channels, elem, tile, corr_box(radius, tile, spacing), chunk, query_rows)
            if 2 * radius + 2 <= min(sched.box) and sched.smem[3] <= CORR_SMEM_BUDGET:
                return sched
        lanes //= 2
    raise ValueError(f"local correlation: radius {radius} needs a box that TMA or shared memory cannot hold")


def _corr_launch(name: str, fn, first: Tensor, target: Tensor, flow: Tensor, out: Tensor, radius: int,
                 schedule: CorrSchedule | None, scale: float | None) -> None:
    """The launch K2 and K3 share: `first` is K2's query or K3's gradient;
    `scale` the dots' scale, by default 1/√C of the target it is handed."""
    for t in (first, target, flow):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if target.data_ptr() % 16 or (name == "local_corr" and first.data_ptr() % 16):
        raise ValueError(f"{name}: tensors must be 16-byte aligned (TMA and 16-byte loads)")
    b, g1, g2, _ = flow.shape
    _, h, w, c = target.shape
    elem = target.element_size()
    if schedule is None:
        schedule = corr_schedule(radius, c, elem, h, w, g1, g2, b, name == "local_corr")
    err = fn(target.device.index, first.data_ptr(), target.data_ptr(), flow.data_ptr(), out.data_ptr(),
             b, g1, g2, h, w, c, int(radius), *schedule.tile, *schedule.box, schedule.chunk, *schedule.smem,
             1.0 / math.sqrt(c) if scale is None else float(scale),
             int(target.dtype == torch.bfloat16), _stream(target.device))
    _check(err, name)


def local_corr(query: Tensor, target: Tensor, flow: Tensor, radius: int,
               schedule: CorrSchedule | None = None, scale: float | None = None) -> Tensor:
    """K2: local correlation windows. query (B, G1, G2, C) and target
    (B, H, W, C) contiguous 16-byte aligned CUDA tensors of one dtype (float32
    or bf16) with C × element size a multiple of 16 bytes, flow (B, G1, G2, 2)
    float32 → (B, G1, G2, (2r+1)²) float32, ky-major. `schedule`: the tiling
    to launch with (`corr_layout`), by default `corr_schedule`'s; `scale`:
    the dots', by default 1/√C (a caller that zero-padded C passes its own)."""
    _require_cuda("local_corr", query, target, flow)
    if query.dtype not in (torch.float32, torch.bfloat16) or target.dtype != query.dtype:
        raise ValueError(f"local_corr: dtypes {query.dtype}, {target.dtype}")
    if flow.dtype != torch.float32:
        raise ValueError(f"local_corr: flow must be float32, got {flow.dtype}")
    if query.dim() != 4 or target.dim() != 4 or flow.shape != query.shape[:3] + (2,):
        raise ValueError(f"local_corr: shapes {tuple(query.shape)}, {tuple(target.shape)}, {tuple(flow.shape)}")
    b, g1, g2, c = query.shape
    if target.shape[0] != b or target.shape[3] != c:
        raise ValueError(f"local_corr: query {tuple(query.shape)} vs target {tuple(target.shape)}")
    if radius < 0:
        raise ValueError(f"local_corr: radius {radius}")
    out = torch.empty((b, g1, g2, (2 * radius + 1) ** 2), dtype=torch.float32, device=query.device)
    _corr_launch("local_corr", load_library().gfnet_local_corr, query, target, flow, out, radius, schedule, scale)
    profiling.count("k2.launches")
    return out


def local_corr_bwd(grad: Tensor, target: Tensor, flow: Tensor, radius: int,
                   schedule: CorrSchedule | None = None, scale: float | None = None) -> Tensor:
    """K3: gradient of K2's windows in the query. grad (B, G1, G2, (2r+1)²)
    float32, target (B, H, W, C) float32 or bf16 (16-byte aligned, C ×
    element size a multiple of 16 bytes), flow (B, G1, G2, 2) float32, all
    contiguous CUDA tensors → dq (B, G1, G2, C) float32. `schedule` as for
    `local_corr`, laid out without query rows; `scale` as for `local_corr`."""
    _require_cuda("local_corr_bwd", grad, target, flow)
    if grad.dtype != torch.float32 or flow.dtype != torch.float32:
        raise ValueError(f"local_corr_bwd: grad and flow must be float32, got {grad.dtype}, {flow.dtype}")
    if target.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"local_corr_bwd: target dtype {target.dtype}")
    if radius < 0:
        raise ValueError(f"local_corr_bwd: radius {radius}")
    taps = (2 * radius + 1) ** 2
    if (grad.dim() != 4 or target.dim() != 4 or grad.shape[3] != taps
            or flow.shape != grad.shape[:3] + (2,) or target.shape[0] != grad.shape[0]):
        raise ValueError(f"local_corr_bwd: shapes {tuple(grad.shape)}, {tuple(target.shape)}, "
                         f"{tuple(flow.shape)} at radius {radius}")
    b, g1, g2, _ = grad.shape
    dq = torch.empty((b, g1, g2, target.shape[3]), dtype=torch.float32, device=grad.device)
    _corr_launch("local_corr_bwd", load_library().gfnet_local_corr_bwd, grad, target, flow, dq, radius, schedule,
                 scale)
    profiling.count("k3.launches")
    return dq


def kde(x: Tensor, sq: Tensor, inv: float) -> Tensor:
    """K4: density[b, i] = Σ_j exp(inv · max(sq_i + sq_j − 2·x_i·x_j, 0))
    over x (B, N, 4) and its squared norms sq (B, N), contiguous, 16-byte
    aligned float32 CUDA tensors → (B, N) float32, in one launch, the row sum
    in the order of the plain path's `sum(-1)` (`csrc/kde.cu`)."""
    _require_cuda("kde", x, sq)
    if x.dtype != torch.float32 or sq.dtype != torch.float32:
        raise ValueError(f"kde: x and sq must be float32, got {x.dtype}, {sq.dtype}")
    if x.dim() != 3 or x.shape[2] != 4 or sq.shape != x.shape[:2]:
        raise ValueError(f"kde: shapes {tuple(x.shape)}, {tuple(sq.shape)}; expected (B, N, 4), (B, N)")
    if not (x.is_contiguous() and sq.is_contiguous()):
        raise ValueError("kde: x and sq must be contiguous")
    if x.data_ptr() % 16 or sq.data_ptr() % 16:
        raise ValueError("kde: x and sq must be 16-byte aligned")
    b, n, _ = x.shape
    if b < 1 or n < 1:
        raise ValueError(f"kde: empty input {tuple(x.shape)}")
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    err = load_library().gfnet_kde(x.device.index, x.data_ptr(), sq.data_ptr(), out.data_ptr(), b, n,
                                   float(inv), _stream(x.device))
    _check(err, "kde")
    profiling.count("k4.launches")
    return out


RESIDUAL_NORM_MAX_DIM = 1536  # K5's widest row: six 8-channel chunks a lane of a warp


def residual_norm(x: Tensor, h: Tensor | None = None, gamma: Tensor | None = None, weight: Tensor | None = None,
                  bias: Tensor | None = None, eps: float = 1e-6) -> tuple[Tensor, Tensor | None]:
    """K5: (s, n) of `ops/residual_norm.residual_norm` in one launch
    (`csrc/residual_norm.cu`): s = x + h·gamma rounded as the plain path
    rounds it (x itself where h is None), n = the float32 layer norm of s by
    weight and bias, cast to the dtype (None where weight is None). x and h
    (..., D) and gamma, weight, bias (D,) are contiguous, 16-byte aligned CUDA
    tensors of one dtype, float32 or bf16, D a multiple of 8 up to
    `RESIDUAL_NORM_MAX_DIM`; none may require grad while grad is on (K5 has
    no backward). Anything else raises."""
    given = [t for t in (x, h, gamma, weight, bias) if t is not None]
    _require_cuda("residual_norm", *given)
    if (h is None) != (gamma is None) or (weight is None) != (bias is None) or (h is None and weight is None):
        raise ValueError("residual_norm: give h with gamma, weight with bias, and at least one pair")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != x.dtype for t in given):
        raise ValueError(f"residual_norm: dtypes {[t.dtype for t in given]}; one of float32 or bf16 for all")
    if torch.is_grad_enabled() and any(t.requires_grad for t in given):
        raise ValueError("residual_norm: K5 has no backward; call it under no_grad or on tensors that need no grad")
    d = x.shape[-1] if x.dim() else 0
    if d % 8 or not 8 <= d <= RESIDUAL_NORM_MAX_DIM:
        raise ValueError(f"residual_norm: D = {d}; K5 takes multiples of 8 up to {RESIDUAL_NORM_MAX_DIM}")
    if (h is not None and h.shape != x.shape) or any(t.shape != (d,) for t in (gamma, weight, bias) if t is not None):
        raise ValueError(f"residual_norm: shapes {[tuple(t.shape) for t in given]}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("residual_norm: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in given):
        raise ValueError("residual_norm: tensors must be 16-byte aligned (16-byte loads)")
    rows = x.numel() // d
    if rows < 1:
        raise ValueError(f"residual_norm: empty input {tuple(x.shape)}")
    s = x if h is None else torch.empty_like(x)
    n = None if weight is None else torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = load_library().gfnet_residual_norm(
        x.device.index, x.data_ptr(), ptr(h), ptr(gamma), ptr(weight), ptr(bias), None if h is None else s.data_ptr(),
        ptr(n), rows, d, float(eps), int(x.dtype == torch.bfloat16), _stream(x.device))
    _check(err, "residual_norm")
    profiling.count("k5.launches")
    return s, n


COUNTERS = {"oneshot_attention": "k1.launches", "local_corr": "k2.launches", "local_corr_bwd": "k3.launches",
            "kde": "k4.launches", "residual_norm": "k5.launches"}


def reset_launch_counts() -> None:
    """Zero the kernels' counters (`k1.*`, `k2.*`, `k3.*`, `k4.*`, `k5.*`)."""
    profiling.reset("k1.", "k2.", "k3.", "k4.", "k5.")


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since `reset_launch_counts()`."""
    counts = profiling.counters()
    return {fn: counts.get(counter, 0) for fn, counter in COUNTERS.items()}


def k1_kernel_counts() -> dict[str, int]:
    """K1's calls since `reset_launch_counts()`, by the CUDA kernel each launched."""
    return {name[len(K1_KERNEL):]: n for name, n in profiling.counters().items() if name.startswith(K1_KERNEL)}
