"""Training entry point: `python -m gfnet_tpu_torch.cli.train --dataset ...`

Counterpart of `gfnet_tpu/cli/train.py`, with its flags (ref `train.py:154-163`:
--conf_path, --dataset, --gpu_batch_size, --ft, --ft_ckpt, plus --data_path,
--workspace, --total_pairs, --ckpt_every, --multihost, ...); `--device`
names the device kind (the matcher's, and the dataset's pixels': files
decode on the host without PIL in `--num_workers` threads, then crops,
augmentations and pair synthesis run there) and defaults to `cuda`. The
loop follows the reference: k-step chunks of 25000 samples with a cosine-LR step and a
checkpoint per chunk (`train.py:65-67,122-138`), a checkpoint on interrupt
(`train.py:143-146`) and auto-resume from the newest checkpoint, and with
`--eval_after` the benchmark on the val set after training (ref
`train.py:176-192`).

`--multihost` runs one process a device (`parallel.mesh.init_distributed`:
torchrun's environment or the JAX package's `GFNET_COORDINATOR`,
`GFNET_NUM_PROCESSES`, `GFNET_PROCESS_ID`); NCCL on cuda, gloo on cpu.
`--gpu_batch_size` is then each rank's batch, read from its own share of the
dataset's files; rank 0 writes the checkpoints and the metrics log, and
every rank restores.

`--trace` turns on the recorder of `utils/profiling.py`: each logged line
then also carries, for each `train.*` span, its mean host ms and device ms a
step since the last log and its `host_syncs` a step (`<span>.host_ms`,
`<span>.device_ms`, `<span>.host_syncs`). `train.data_wait` is the wait for
the next batch, the loader's share the step does not hide.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import time
from argparse import ArgumentParser
from typing import Iterable

from gfnet_tpu_torch.utils import profiling


def span_metrics(seen: int) -> tuple[dict, int]:
    """The `train.*` spans of the requests after request `seen`, a step
    each: {`<span>.host_ms`, `<span>.device_ms`, `<span>.host_syncs`}, and
    the last request read."""
    recs = [r for r in profiling.records() if r["request"] > seen]
    out = {}
    for name, s in profiling.summarize(recs, per="train.step", prefix="train.").items():
        out.update({f"{name}.{k}": v for k, v in s.items() if v is not None})
    return out, max((r["request"] for r in recs), default=seen)


def train_loop(state, step_fn, batches: Iterable[dict], ckpt, total_steps: int, chunk_steps: int,
               global_batch: int, logger=None, log_every: int = 50):
    """Run `step_fn` over `batches` (any iterable of batch dicts) until
    `state.step` reaches `total_steps`, in chunks of `chunk_steps` with a
    checkpoint after each and one at the end. Returns the state."""
    batches = iter(batches)
    t_last = time.perf_counter()
    seen = 0  # the last request whose spans were logged
    while state.step < total_steps:
        chunk = itertools.islice(batches, min(chunk_steps, total_steps - state.step))
        while True:
            with profiling.span("train.data_wait"):
                batch = next(chunk, None)
            if batch is None:
                break
            state, metrics = step_fn(state, batch)
            if logger is not None and state.step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t_last
                m["samples_per_s"] = log_every * global_batch / dt
                if profiling.recording():
                    spans, seen = span_metrics(seen)
                    m.update(spans)
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
    parser.add_argument("--num_workers", type=int, default=8,
                        help="threads decoding image files ahead of the batch being made")
    parser.add_argument("--multihost", action="store_true",
                        help="one process a device over torch.distributed (torchrun's or "
                             "GFNET_COORDINATOR/GFNET_NUM_PROCESSES/GFNET_PROCESS_ID's environment)")
    parser.add_argument("--dinov2_weights", type=str,
                        default=os.environ.get("DINOV2_NPZ", "weights/dinov2_vitl14.npz"))
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--tiny", action="store_true",
                        help="debug: tiny architecture + CPU-friendly sizes")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; cuda without a GPU is an error")
    parser.add_argument("--eval_after", action="store_true",
                        help="run the benchmark on the val set after training")
    parser.add_argument("--eval_max_pairs", type=int, default=None)
    parser.add_argument("--trace", action="store_true",
                        help="record the train step's spans and log their ms and host syncs a step")
    args, _ = parser.parse_known_args(argv)

    import torch

    from gfnet_tpu_torch.config import ModelConfig, TrainConfig, tiny_test_config
    from gfnet_tpu_torch.matcher.api import GFNetMatcher
    from gfnet_tpu_torch.parallel.mesh import init_distributed
    from gfnet_tpu_torch.train.checkpoint import Checkpointer
    from gfnet_tpu_torch.train.loss import RobustLoss
    from gfnet_tpu_torch.train.state import create_train_state
    from gfnet_tpu_torch.train.step import make_train_step
    from gfnet_tpu_torch.utils.convert import load_head, load_vit
    from gfnet_tpu_torch.utils.logging import MetricLogger

    mesh, device = None, args.device
    started_group = args.multihost and not torch.distributed.is_initialized()
    if args.multihost:
        mesh = init_distributed(args.device)
        device = mesh.device
    proc, nproc = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    if args.tiny:
        cfg = tiny_test_config()
    else:
        cfg = ModelConfig.from_json(args.conf_path) if args.conf_path else ModelConfig()
    vit_state = head_state = None
    if os.path.exists(args.dinov2_weights):
        vit_state = load_vit(args.dinov2_weights)
        print(f"loaded DINOv2 weights from {args.dinov2_weights}")
    else:
        print(f"WARNING: no DINOv2 weights at {args.dinov2_weights}; "
              "training with a random frozen backbone")
    if args.ft and args.ft_ckpt:  # fine-tune bootstrap (ref `train.py:53-56`)
        head_state, kv_norm = load_head(args.ft_ckpt)
        cfg = cfg.with_head_kv_norm(kv_norm)
        print(f"loaded fine-tune init from {args.ft_ckpt}")
    # bf16 always, as the JAX package's `GFNetMatcher(cfg)`: `cfg.amp` picks nothing
    matcher = GFNetMatcher(cfg, device=device, dtype=torch.bfloat16, vit_state=vit_state,
                           head_state=head_state)

    global_batch = args.batch_size * nproc
    tcfg = TrainConfig(total_pairs=args.total_pairs, ckpt_every_pairs=args.ckpt_every,
                       per_host_batch_size=args.batch_size)
    loss = RobustLoss(ce_weight=tcfg.ce_weight, alpha=tcfg.alpha, c=tcfg.c,
                      iteration_base=tcfg.iteration_base,
                      local_largest_scale=tcfg.local_largest_scale,
                      local_dist=tcfg.local_dist, im_size=cfg.initial_res[0])
    state = create_train_state(matcher.head, tcfg, global_batch)
    ckpt = Checkpointer(args.workspace, args.dataset, mesh=mesh)
    if ckpt.restore(state) is not None:
        print(f"auto-resumed from step {state.step}")

    step_fn = make_train_step(matcher, loss, mesh)
    k = max(args.ckpt_every // global_batch, 1)
    total_steps = args.total_pairs // global_batch
    loader = None
    if batches is None:
        from gfnet_tpu_torch.data.dataset import BatchLoader, HomographyDataset

        dataset = HomographyDataset(dataset=args.dataset, mode="train", data_path=args.data_path,
                                    input_resolution=cfg.initial_res, process_index=proc,
                                    process_count=nproc, device=device)
        loader = BatchLoader(dataset, args.batch_size, num_workers=args.num_workers, seed=proc)
        batches = loader.batches(max(total_steps - state.step, 0))
    logger = MetricLogger(enabled=proc == 0, jsonl_path=os.path.join(args.workspace, "metrics.jsonl"))
    print(f"training {total_steps} steps (global batch {global_batch}), k={k}")
    if args.trace:
        profiling.enable()
    try:
        train_loop(state, step_fn, batches, ckpt, total_steps, k, global_batch, logger,
                   args.log_every)
    except KeyboardInterrupt:  # ref `train.py:143-146`
        ckpt.save(state)
        print("interrupted: checkpoint saved")
        sys.exit(0)
    finally:
        if args.trace:
            profiling.disable()
        if loader is not None:
            loader.close()
    print("training complete")

    if args.eval_after and proc == 0:
        from gfnet_tpu_torch.data.dataset import HomographyDataset
        from gfnet_tpu_torch.eval.benchmark import HomographyBenchmark

        val_name = {"glunet_448x448_occlusion": "mscoco"}.get(args.dataset, args.dataset)
        try:
            val_ds = HomographyDataset(dataset=val_name, mode="val", data_path=args.data_path,
                                       input_resolution=cfg.initial_res, device=device)
            results = HomographyBenchmark(val_ds).run(matcher, max_pairs=args.eval_max_pairs)
            logger.log(results, step=state.step * global_batch)
            print(json.dumps(results, indent=2))
        except (KeyError, FileNotFoundError) as e:
            print(f"eval_after skipped: val data unavailable ({e})")
    if started_group:
        mesh.barrier()
        torch.distributed.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
