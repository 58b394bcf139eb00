"""Where K1's time goes on one GPU: its softmax ablated, mode by mode.

Counterpart of `scripts/profile_oneshot_parts.py` (the same ablations of the
Pallas K1 on a TPU). Builds `gfnet_tpu_torch/csrc/oneshot_attention.cu` once
for each mode, with `-DGFNET_K1_ABLATION=<mode>`, into
`gfnet_tpu_torch/_build/` beside the package's own library (which is built
without the macro and holds the full kernel alone), and times each mode's K1
launch with CUDA events around launches queued behind a spin kernel
(`chip_smoke.cuda_ms`), bf16, at (2,1601,16,64) (the `wgmma` kernel at the
ViT's 560² pass) and (2,1024,1,320) (the wide kernel, kv split 4 ways, with
its merge):

  full      the kernel as the package builds it;
  dots      S and P·V only: P is the logits cast to bf16; no mask, max,
            exponential or sum;
  max       the running max and the rescale, P the shifted logits in bf16;
            no exponential, no sum;
  exp_bf16  the exponentials by `ex2.approx.ftz.bf16x2` (sm_90), two a call,
            of the shifted logits rounded to bf16.

The modes run in turns, twice (forward, then backward order), in one process.
Prints the card's name and power limit, then one JSON line a shape: each
mode's ms (both turns and their mean), the package library's ms beside the
`full` build's, the bound, and the share of `full`'s time that each step from
`dots` to `full` adds. Run from the repository root:

    python3 scripts/profile_oneshot_parts_torch.py
"""

from __future__ import annotations

import ctypes
import json
import sys
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gfnet_tpu_torch.ops import kernels  # noqa: E402
from gfnet_tpu_torch.utils.profiling import PEAK_BF16_FLOPS, bound  # noqa: E402

MODES = ("full", "dots", "max", "exp_bf16")  # the values 0-3 of GFNET_K1_ABLATION
SHAPES = ((2, 1601, 16, 64), (2, 1024, 1, 320))
ITERS = 50


def build_variants() -> dict:
    """One library a mode, built together (one `nvcc` each), loaded."""
    tag = kernels._source_hash()
    dirs = {mode: kernels.BUILD_ROOT / f"k1_ablation_{mode}_{tag}" for mode in MODES}
    errors = []

    def build(i, mode):
        try:
            if not (dirs[mode] / kernels.LIB_NAME).exists():
                kernels._build(dirs[mode], ("oneshot_attention.cu",), (f"-DGFNET_K1_ABLATION={i}",))
        except Exception as e:  # reported after every build has ended
            errors.append(f"{mode}: {e}")

    threads = [threading.Thread(target=build, args=(i, mode)) for i, mode in enumerate(MODES)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    libs = {}
    for mode in MODES:
        lib = ctypes.CDLL(str(dirs[mode] / kernels.LIB_NAME))
        kernels.declare_attention(lib)
        libs[mode] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_oneshot_parts_torch: needs a GPU", file=sys.stderr)
        return 2
    info = chip_smoke.phase_device(torch)
    kernels.load_library()
    libs = build_variants()
    gen = torch.Generator("cuda").manual_seed(5)
    for b, n, h, d in SHAPES:
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        scale = d**-0.5
        dk, dv, splits, kv_split = kernels._attention_plan(True, b, n, n, h, d, 0)
        if (dk, dv) != (d, d):
            raise ValueError(f"{(b, n, h, d)}: the ablations run at the kernels' own widths, not {dk}, {dv}")
        launch = {mode: (lambda lib=lib: kernels._attention_launch(q, k, v, scale, splits, kv_split, lib=lib))
                  for mode, lib in libs.items()}
        launch["package"] = lambda: kernels._attention_launch(q, k, v, scale, splits, kv_split)
        kernels.reset_launch_counts()
        if not torch.equal(launch["full"](), launch["package"]()):
            raise AssertionError(f"{(b, n, h, d)}: the `full` build and the package's library differ")
        (route,) = set(kernels.k1_kernel_counts())  # the kernel both builds reported they launched
        order = list(launch)
        times = {name: [] for name in order}
        for turn in (order, order[::-1]):
            for name in turn:
                times[name].append(chip_smoke.cuda_ms(torch, launch[name], ITERS))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        bound_ms, bound_by = bound([(4 * b * n * n * h * d, PEAK_BF16_FLOPS)], 4 * b * n * h * d * 2, b * h * n * n,
                                   info["exp_per_s"])
        full = ms["full"]
        print(json.dumps({
            "shape": [b, n, h, d], "dtype": "bfloat16", "route": route,
            "kv_splits": splits, "ms": ms, "ms_turns": times, "bound_ms": bound_ms, "bound_by": bound_by,
            # what each step adds, as a share of the full kernel's time
            "share": {"products_and_memory (dots)": ms["dots"] / full,
                      "max_and_rescale (max - dots)": (ms["max"] - ms["dots"]) / full,
                      "exponentials_and_sum (full - max)": (full - ms["max"]) / full},
            "exp_bf16_vs_full": ms["exp_bf16"] / full}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
