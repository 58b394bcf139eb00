"""Training entry point: `python -m gfnet_tpu_torch.cli.train --dataset ...`

Counterpart of `gfnet_tpu/cli/train.py`, with its flags (ref `train.py:154-163`:
--conf_path, --dataset, --gpu_batch_size, --ft, --ft_ckpt, plus --data_path,
--workspace, --total_pairs, --ckpt_every, ...) on one device; `--device`
names it and defaults to `cuda`. The loop follows the reference: k-step
chunks of 25000 samples with a cosine-LR step and a checkpoint per chunk
(`train.py:65-67,122-138`), a checkpoint on interrupt (`train.py:143-146`)
and auto-resume from the newest checkpoint. Several devices and
`--eval_after` are not ported yet.
"""

from __future__ import annotations

import itertools
import os
import sys
import time
from argparse import ArgumentParser
from typing import Iterable


def train_loop(state, step_fn, batches: Iterable[dict], ckpt, total_steps: int, chunk_steps: int,
               global_batch: int, logger=None, log_every: int = 50):
    """Run `step_fn` over `batches` (any iterable of batch dicts) until
    `state.step` reaches `total_steps`, in chunks of `chunk_steps` with a
    checkpoint after each and one at the end. Returns the state."""
    batches = iter(batches)
    t_last = time.perf_counter()
    while state.step < total_steps:
        chunk = min(chunk_steps, total_steps - state.step)
        for batch in itertools.islice(batches, chunk):
            state, metrics = step_fn(state, batch)
            if logger is not None and state.step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t_last
                m["samples_per_s"] = log_every * global_batch / dt
                t_last = time.perf_counter()
                logger.log(m, step=state.step * global_batch)
        ckpt.save(state)
        print(f"checkpointed at step {state.step} ({state.step * global_batch} pairs)")
    ckpt.save(state)
    return state


def main(argv=None, batches: Iterable[dict] | None = None):
    """Train from the command line. `batches`, when given, replaces the
    dataset on disk: any iterable of batch dicts (im_A, im_B, H_s2t)."""
    parser = ArgumentParser()
    parser.add_argument("--conf_path", type=str, default=None)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--gpu_batch_size", "--per_host_batch_size", dest="batch_size",
                        default=8, type=int)
    parser.add_argument("--ft", action="store_true", default=False)
    parser.add_argument("--ft_ckpt", type=str, default=None)
    parser.add_argument("--data_path", type=str, default=os.environ.get("DATA_PATH", "data"))
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--total_pairs", type=int, default=2_000_000)
    parser.add_argument("--ckpt_every", type=int, default=25_000)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--dinov2_weights", type=str,
                        default=os.environ.get("DINOV2_NPZ", "weights/dinov2_vitl14.npz"))
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--tiny", action="store_true",
                        help="debug: tiny architecture + CPU-friendly sizes")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; cuda without a GPU is an error")
    parser.add_argument("--eval_after", action="store_true",
                        help="not ported yet: the benchmark after training")
    parser.add_argument("--eval_max_pairs", type=int, default=None)
    args, _ = parser.parse_known_args(argv)

    import torch

    from gfnet_tpu_torch.config import ModelConfig, TrainConfig, tiny_test_config
    from gfnet_tpu_torch.matcher.api import GFNetMatcher
    from gfnet_tpu_torch.train.checkpoint import Checkpointer
    from gfnet_tpu_torch.train.loss import RobustLoss
    from gfnet_tpu_torch.train.state import create_train_state
    from gfnet_tpu_torch.train.step import make_train_step
    from gfnet_tpu_torch.utils.convert import load_head_npz, load_vit_npz
    from gfnet_tpu_torch.utils.logging import MetricLogger

    if args.eval_after:
        print("--eval_after is not ported yet (it waits for the evaluation modules); "
              "training runs without the benchmark")
    if args.tiny:
        cfg = tiny_test_config()
    else:
        cfg = ModelConfig.from_json(args.conf_path) if args.conf_path else ModelConfig()
    vit_state = head_state = None
    if os.path.exists(args.dinov2_weights):
        vit_state = load_vit_npz(args.dinov2_weights)
        print(f"loaded DINOv2 weights from {args.dinov2_weights}")
    else:
        print(f"WARNING: no DINOv2 weights at {args.dinov2_weights}; "
              "training with a random frozen backbone")
    if args.ft and args.ft_ckpt:  # fine-tune bootstrap (ref `train.py:53-56`)
        if not args.ft_ckpt.endswith(".npz"):
            raise ValueError(f"--ft_ckpt takes an .npz head, got {args.ft_ckpt}")
        head_state, kv_norm = load_head_npz(args.ft_ckpt)
        cfg = cfg.with_kv_norm(kv_norm)
        print(f"loaded fine-tune init from {args.ft_ckpt}")
    dtype = torch.float32 if args.tiny or not cfg.amp else torch.bfloat16
    matcher = GFNetMatcher(cfg, device=args.device, dtype=dtype, vit_state=vit_state,
                           head_state=head_state)

    global_batch = args.batch_size
    tcfg = TrainConfig(total_pairs=args.total_pairs, ckpt_every_pairs=args.ckpt_every,
                       per_host_batch_size=args.batch_size)
    loss = RobustLoss(ce_weight=tcfg.ce_weight, alpha=tcfg.alpha, c=tcfg.c,
                      iteration_base=tcfg.iteration_base,
                      local_largest_scale=tcfg.local_largest_scale,
                      local_dist=tcfg.local_dist, im_size=cfg.initial_res[0])
    state = create_train_state(matcher.head, tcfg, global_batch)
    ckpt = Checkpointer(args.workspace, args.dataset)
    if ckpt.restore(state) is not None:
        print(f"auto-resumed from step {state.step}")

    step_fn = make_train_step(matcher, loss)
    k = max(args.ckpt_every // global_batch, 1)
    total_steps = args.total_pairs // global_batch
    loader = None
    if batches is None:
        from gfnet_tpu_torch.data.dataset import BatchLoader, HomographyDataset

        dataset = HomographyDataset(dataset=args.dataset, mode="train", data_path=args.data_path,
                                    input_resolution=cfg.initial_res)
        loader = BatchLoader(dataset, args.batch_size, num_workers=args.num_workers, seed=0)
        batches = loader.batches(max(total_steps - state.step, 0))
    logger = MetricLogger(jsonl_path=os.path.join(args.workspace, "metrics.jsonl"))
    print(f"training {total_steps} steps (global batch {global_batch}), k={k}")
    try:
        train_loop(state, step_fn, batches, ckpt, total_steps, k, global_batch, logger,
                   args.log_every)
    except KeyboardInterrupt:  # ref `train.py:143-146`
        ckpt.save(state)
        print("interrupted: checkpoint saved")
        sys.exit(0)
    finally:
        if loader is not None:
            loader.close()
    print("training complete")
    return state


if __name__ == "__main__":
    main()
