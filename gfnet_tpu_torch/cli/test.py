"""Evaluation entry point: `python -m gfnet_tpu_torch.cli.test --dataset mscoco ...`

Counterpart of `gfnet_tpu/cli/test.py`, with its flags (ref `test.py:14-18`:
--conf_path, --ckpt_path, --dataset, plus --data_path, --max_pairs,
--dinov2_weights, --tiny, --batch); `--device` names the device of the
matcher and of the dataset's pixels (files decode on the host without PIL,
`data/imageio`) and defaults to `cuda`. Reports auc@{3,5,10,20}, mean ACE
and runtime (ref `test.py:70-75`) as the same JSON. Without DINOv2 weights the backbone is
the JAX package's seed-0 random ViT (`utils/jax_init.py`).
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--conf_path", type=str, default=None)
    parser.add_argument("--ckpt_path", type=str, default=None)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--data_path", type=str, default=os.environ.get("DATA_PATH", "data"))
    parser.add_argument("--max_pairs", type=int, default=None)
    parser.add_argument("--dinov2_weights", type=str,
                        default=os.environ.get("DINOV2_NPZ", "weights/dinov2_vitl14.npz"))
    parser.add_argument("--tiny", action="store_true",
                        help="debug: tiny architecture + CPU-friendly sizes")
    parser.add_argument("--batch", type=int, default=None,
                        help="evaluate pairs in batches of B through "
                             "estimate_homography_batched (default: the "
                             "reference's serial per-pair protocol)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; cuda without a GPU is an error")
    args, _ = parser.parse_known_args(argv)

    import torch

    from gfnet_tpu_torch.config import ModelConfig, tiny_test_config
    from gfnet_tpu_torch.data.dataset import HomographyDataset
    from gfnet_tpu_torch.eval.benchmark import HomographyBenchmark
    from gfnet_tpu_torch.matcher.api import GFNetMatcher
    from gfnet_tpu_torch.utils.convert import load_head, load_vit

    if args.tiny:
        cfg = tiny_test_config()
        res = cfg.initial_res[0]
    else:
        cfg = ModelConfig.from_json(args.conf_path) if args.conf_path else ModelConfig()
        res = {"googlemap_224x224": 224, "googlemap_672x672": 672}.get(
            args.dataset, cfg.initial_res[0]
        )
    # eval always runs symmetric + two-pass upsampling (ref `test.py:25-30`)
    cfg = cfg.replace(symmetric=True, upsample_preds=True, attenuate_cert=True)

    vit_state = head_state = None
    if os.path.exists(args.dinov2_weights):
        vit_state = load_vit(args.dinov2_weights)
    else:
        print(f"WARNING: no DINOv2 weights at {args.dinov2_weights}; random backbone")
    if args.ckpt_path:
        head_state, kv_norm = load_head(args.ckpt_path)
        cfg = cfg.with_head_kv_norm(kv_norm)
        print(f"loaded checkpoint {args.ckpt_path}")
    # bf16 always, as the JAX package's `GFNetMatcher(cfg)`: `cfg.amp` picks nothing
    matcher = GFNetMatcher(cfg, device=args.device, dtype=torch.bfloat16, vit_state=vit_state,
                           head_state=head_state)

    ds_name = {"googlemap_448x448": "googlemap"}.get(args.dataset, args.dataset)
    dataset = HomographyDataset(
        dataset=ds_name, mode="val", data_path=args.data_path, input_resolution=(res, res),
        device=args.device,
    )
    bench = HomographyBenchmark(dataset)
    results = bench.run(
        matcher, max_pairs=args.max_pairs, verbose=True, batch_size=args.batch
    )
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
