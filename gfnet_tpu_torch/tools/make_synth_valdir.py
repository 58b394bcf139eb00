"""Write a synthetic homography test set in the reference's val layout.

Counterpart of the JAX package's `tools/make_synth_valdir.py`, with its
flags and layout: <out>/test/<name>/{source,target,H_s2t}/NNNNN.{png,json},
`{"H": 3x3}` mapping source pixels to target pixels at the stored
resolution (`test.py:41-55`, dataset `:92-119`). The pairs are
`eval/synthetic.eval_pairs` made on `--device` (default `cuda`; `cpu` when
asked), written through `data/imageio.write_png`: no PIL, no cv2.

    python -m gfnet_tpu_torch.tools.make_synth_valdir --n 100 --res 448 \\
        --deformation 0.3 --out data [--cross_modal] [--device cpu]

then `python -m gfnet_tpu_torch.cli.test --dataset synthetic --data_path data`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--res", type=int, default=448)
    p.add_argument("--deformation", type=float, default=0.3,
                   help="reference training deformation (`train.py:82`)")
    p.add_argument("--cross_modal", action="store_true")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--out", type=str, default="data")
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the pairs are made: cuda (default) or cpu")
    args = p.parse_args(argv)

    from gfnet_tpu_torch.data.imageio import write_png
    from gfnet_tpu_torch.eval.synthetic import eval_pairs

    name = args.name or f"synth_1k_{args.res}x{args.res}" + ("_cm" if args.cross_modal else "")
    root = os.path.join(args.out, "test", name)
    for sub in ("source", "target", "H_s2t"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    pairs = eval_pairs(args.n, args.res, args.deformation, seed=args.seed,
                       cross_modal=args.cross_modal, device=args.device)
    for i, s in enumerate(pairs):
        stem = f"{i:05d}"
        # val mode reads source/ as im_A and target/ as im_B; H maps source → target
        write_png(os.path.join(root, "source", stem + ".png"), s["im_A"])
        write_png(os.path.join(root, "target", stem + ".png"), s["im_B"])
        with open(os.path.join(root, "H_s2t", stem + ".json"), "w") as f:
            json.dump({"H": np.asarray(s["H_s2t"], np.float64).tolist()}, f)
    print(f"wrote {len(pairs)} pairs to {root}")
    return root


if __name__ == "__main__":
    main()
