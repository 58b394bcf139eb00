"""K1 (oneshot_attention) alone on one GPU: build, check, time.

Runs phases 1-3 of `chip_smoke.py` (the card's name and power limit, the
kernels' build with the compiler's register report, K1 against its plain
versions and beside `F.scaled_dot_product_attention` at the main path's
shapes, the host's cost of a launch) and nothing else, for work on the
attention kernels. One JSON line per phase and shape; run from the
repository root:

    python3 scripts/bench_k1_torch.py

With `--against DIR` it also loads `gfnet_tpu_torch/ops/kernels.py` of another
checkout (an earlier commit unpacked beside this one), builds that checkout's
kernels, and reports only the host's cost of a launch through either
launcher, in turns within this one process.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # a dataclass looks its module up there
    spec.loader.exec_module(module)
    return module


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout whose launcher's host cost is measured beside this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k1_torch: needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    chip_smoke = load("chip_smoke", ROOT / "chip_smoke.py")
    info = chip_smoke.phase_device(torch)
    chip_smoke.phase_build()
    if args.against is None:
        chip_smoke.phase_k1(torch, info["exp_per_s"])
        return 0
    from gfnet_tpu_torch.ops import kernels

    other = load("other_kernels", args.against / "gfnet_tpu_torch" / "ops" / "kernels.py")
    other.load_library()
    chip_smoke.k1_host_cost(torch, [(2, 1025, 16, 64, 0.125), (2, 1024, 8, 8, 0.354)],
                            {"this": kernels.oneshot_attention, str(args.against): other.oneshot_attention})
    return 0


if __name__ == "__main__":
    sys.exit(main())
