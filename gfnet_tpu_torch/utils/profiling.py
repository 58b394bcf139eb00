"""Profiling and roofline accounting on the card.

Counterpart of `gfnet_tpu/utils/profiling.py`:
  - `trace(logdir)`: a context manager around `torch.profiler.profile` (the
    CPU's activity, and the card's where there is one) that writes a Chrome
    trace into `logdir`;
  - `timed(fn, *args)`: the median wall seconds of a call, synchronised
    with the card when the call ran on it;
  - `OpCost`, `model_op_costs(cfg)`, `roofline_report(cfg)`: the same static
    FLOP and byte count of the engine's dominant ops as the JAX package's,
    timed against the H100's peaks instead of the TPU's;
  - `bound(ops, nbytes)`: the least time the card could take for a kernel's
    work, which `chip_smoke.py` sets beside each kernel's time.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from dataclasses import dataclass

import torch

# NVIDIA H100 SXM (80GB HBM3) peaks, from NVIDIA's data sheet, dense, at the
# 700 W power limit: a card set below it runs slower under load.
PEAK_BF16_FLOPS = 989e12  # tensor cores, bf16 and fp16
PEAK_F32_FLOPS = 67e12    # float32 outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12  # tensor cores, TF32 (a float32 product in three TF32 passes takes three)
PEAK_BYTES = 3.35e12      # HBM3, bytes a second


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body with `torch.profiler` (CPU activity, and CUDA
    activity when a card is present) and write its Chrome trace to
    `logdir/trace.json`. Yields the profiler, whose `key_averages()` the
    caller may read after the body."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync(out) -> None:
    """Wait for the card if any tensor of `out` (a tensor, or a tuple, list
    or dict of them) lies on it."""
    leaves = out.values() if isinstance(out, dict) else out if isinstance(out, (tuple, list)) else (out,)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()


def timed(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median wall seconds of one `fn(*args)`, the host's launch cost and
    the card's time together: each call ends when its result is ready."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bound(ops: list, nbytes: float, exps: float = 0.0, exp_rate: float = 1.0) -> tuple[float, str]:
    """The least time in ms the card could take, and which term sets it:
    operations over their peak rate (`ops`: (count, rate) pairs, one for
    each operand type, whose times add), bytes over the memory rate, or
    exponentials over the special-function units' rate (`exp_rate` a second)."""
    terms = {"operations": sum(n / rate for n, rate in ops), "bytes": nbytes / PEAK_BYTES,
             "exponentials": exps / exp_rate}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by


@dataclass
class OpCost:
    """One op's FLOPs and bytes, timed against the card's bf16 and memory peaks."""

    name: str
    flops: float
    bytes: float

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_BF16_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes / PEAK_BYTES

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s > self.memory_s else "memory"


def model_op_costs(cfg, batch: int = 1, symmetric: bool = True) -> list[OpCost]:
    """Static cost of the engine's dominant ops at `cfg.initial_res`: the
    JAX package's formulas, term for term, so both give the same numbers."""
    h, w = cfg.initial_res
    p = cfg.dino.patch_size
    n_tok = (h // p) * (w // p) + 1
    d = cfg.dino.d_model
    views = 2 * batch
    costs = []

    # ViT blocks: qkv + proj (4 d²) and the MLP (8 d²) a token, plus the
    # attention's two products, 2 FLOPs a multiply-add
    vit_flops = views * cfg.dino.depth * n_tok * (12 * d * d * 2 + 2 * 2 * n_tok * d * 2)
    vit_bytes = cfg.dino.depth * 12 * d * d * 2  # bf16 weights, read once a pass
    costs.append(OpCost("dinov2_backbone", vit_flops, vit_bytes + views * n_tok * d * 4))

    # the global correlation and its softmax expectation at the ViT grid
    g = cfg.matcher.num_grid[0]
    b_eff = views if symmetric else batch
    corr_flops = b_eff * (g * g) * (g * g) * cfg.encoder.feat_chs[0] * 2
    costs.append(OpCost("global_correlation", corr_flops, b_eff * g * g * g * g * 4))

    # the local correlation windows of each scale with radius > 0
    feat_ch = {16: cfg.encoder.feat_chs[0], 8: cfg.encoder.feat_chs[0],
               4: cfg.encoder.feat_chs[1], 2: cfg.encoder.feat_chs[2]}
    for i, scale in enumerate((16, 8, 4, 2)):
        r = cfg.matcher.radius[i]
        if r <= 0:
            continue
        gi = cfg.matcher.num_grid[i]
        k = (2 * r + 1) ** 2
        c = feat_ch[scale]
        costs.append(OpCost(f"local_corr_s{scale}", b_eff * gi * gi * k * c * 2 * 4,  # 4 bilinear corners
                            b_eff * gi * gi * k * c * 4 * 4))

    # the FPN encoder's first convolutions at full resolution
    enc = cfg.encoder.feat_chs[::-1]
    conv_flops = views * h * w * (3 * enc[0] * 49 + enc[0] * enc[0] * 25) * 2
    costs.append(OpCost("fpn_encoder_fullres", conv_flops, views * h * w * enc[0] * 4))
    return costs


def roofline_report(cfg, batch: int = 1) -> str:
    """`model_op_costs` as a table: GFLOP, MB, the time each would take at
    the card's compute and memory peaks (ms), and which bounds it."""
    lines = [f"{'op':24s} {'GFLOP':>9s} {'MB':>9s} {'t_comp':>9s} {'t_mem':>9s}  bound"]
    for c in model_op_costs(cfg, batch):
        lines.append(f"{c.name:24s} {c.flops / 1e9:9.2f} {c.bytes / 1e6:9.2f} "
                     f"{c.compute_s * 1e3:8.3f}m {c.memory_s * 1e3:8.3f}m  {c.bound}")
    return "\n".join(lines)
