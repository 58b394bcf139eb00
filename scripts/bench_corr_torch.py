"""K2 (local_corr) and K3 (local_corr_bwd) alone on one GPU: build, check, time.

Runs phases 1, 2, 4 and 7 of `chip_smoke.py` (the card's name and power
limit, the kernels' build with the compiler's register report, K2 at the
inference shapes in bf16, K3 and K2 at the train step's shapes) and nothing
else, for work on the local-correlation kernels. Every shape runs on a
homography flow and on a random one, with the share of tiles that staged;
on the homography flow also with staging off (the same tiles, a box of one
window), which times what staging buys. Then the host's cost of a K2 and a
K3 launch.
One JSON line per phase and row, then a markdown table of the rows; run from
the repository root:

    python3 scripts/bench_corr_torch.py

With `--against DIR` it also loads `gfnet_tpu_torch/ops/kernels.py` of another
checkout (an earlier commit unpacked beside this one, e.g. with
`git archive <commit> gfnet_tpu_torch | tar -x -C _archive/parent`), builds
that checkout's kernels, and times its K2 and K3 beside this checkout's on
the same inputs, in turns within this one process (this, earlier, earlier,
this), so that the "earlier" column and this one share a card and a host,
and the host's cost of their launches in turns too.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
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


def table(rows: list, smi: str) -> str:
    """One markdown line a row: kernel, shape, flow, times, bound, staged share."""
    out = [f"({smi})", "",
           "| kernel | shape | flow | ms | earlier ms | unstaged ms | bound ms | plain ms | staged share "
           "| max abs err |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for kernel, row in rows:
        shape = f"r{row['radius']} q{row.get('query', row.get('grad'))[1]}² t{row['target'][1]}² " \
                f"C{row['target'][3]} B{row['target'][0]} {row.get('target_dtype', row.get('dtype', 'bfloat16'))}"
        earlier, unstaged = (f"{row[k]:.4f}" if k in row else "" for k in ("earlier_ms", "unstaged_ms"))
        out.append(f"| {kernel} | {shape} | {row['flow']} | {row['kernel_ms']:.4f} | {earlier} | {unstaged} | "
                   f"{row['bound_ms']:.4f} ({row['bound_by']}) | "
                   f"{row['plain_ms']:.3f} | {row['staged_share']:.3f} | {row['max_abs_err']:.2e} |")
    return "\n".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout whose K2 and K3 are timed beside this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_corr_torch: needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    chip_smoke = load("chip_smoke", ROOT / "chip_smoke.py")
    info = chip_smoke.phase_device(torch)
    chip_smoke.phase_build()
    other = None
    if args.against is not None:
        other = load("other_kernels", args.against / "gfnet_tpu_torch" / "ops" / "kernels.py")
        other.load_library()

    rows: list = []
    real_emit = chip_smoke.emit

    def emit(phase: str, **kw) -> None:  # keeps the rows for the table
        real_emit(phase, **kw)
        if phase in ("k2", "k2_train", "k3"):
            rows.append(({"k2": "K2", "k2_train": "K2", "k3": "K3"}[phase], kw))

    chip_smoke.emit = emit
    k2 = chip_smoke.phase_k2(torch, other)
    k3 = chip_smoke.phase_k3(torch, other)
    print(json.dumps({"summary": {"local_corr": k2, "local_corr_bwd": k3}}), flush=True)
    print(table(rows, info["nvidia_smi"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
