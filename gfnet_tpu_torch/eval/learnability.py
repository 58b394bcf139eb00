"""End-to-end learnability: synthetic homography stream → train → benchmark.

Counterpart of `scripts/learnability_e2e.py` at its tiny defaults: the tiny
config in float32, ViT and head as the JAX package's `GFNetMatcher(cfg,
seed=seed)` draws them (`utils/jax_init.py`), trained for `steps` steps of
`batch` synthetic pairs (lr_per_sample 4e-4, clip 1.0, deformation 0.15),
then `benchmark_mace` on `eval_pairs(16, 112, 0.15, seed=1234)` at 2000
matches under `PRNGKey(0)`, before and after. Each batch comes from its
own generator, drawn from `default_rng(seed + 1)` as the JAX script draws
its batches, and is made on the device with tensor ops
(`eval/synthetic.train_batch(..., device=...)`), so the card's machine
needs no `cv2`. The JAX script read 67.42 px with random weights and
2.96 px after 500 steps on the CPU (`workspace/learnability_500.json`).

    python -m gfnet_tpu_torch.eval.learnability --device cuda --out learn.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def run(device="cuda", steps: int = 500, batch: int = 8, n_eval: int = 16, eval_matches: int = 2000,
        deformation: float = 0.15, lr_per_sample: float = 4e-4, grad_clip: float = 1.0,
        seed: int = 0, log_every: int = 0) -> dict:
    """Train the tiny config from the seed's weights and benchmark it; returns
    the readings (MACE before and after, per-pair errors, first and last
    loss, the best coarse pck, seconds: in all, training, and of training
    those spent making batches and in the steps)."""
    from gfnet_tpu_torch.config import TrainConfig, tiny_test_config
    from gfnet_tpu_torch.eval.synthetic import benchmark_mace, eval_pairs, train_batch
    from gfnet_tpu_torch.matcher import GFNetMatcher
    from gfnet_tpu_torch.train.loss import RobustLoss
    from gfnet_tpu_torch.train.state import create_train_state
    from gfnet_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    cfg = tiny_test_config()
    res = cfg.initial_res[0]
    matcher = GFNetMatcher(cfg, device=device, dtype=torch.float32, seed=seed)
    bench = eval_pairs(n_eval, res, deformation, seed=1234, device=device)
    mace0, errors0 = benchmark_mace(matcher, bench, num_matches=eval_matches)
    tcfg = TrainConfig(grad_clip_norm=grad_clip, lr_per_sample=lr_per_sample)
    state = create_train_state(matcher.head, tcfg, global_batch=batch)
    step = make_train_step(matcher, RobustLoss(im_size=res))
    rng = np.random.default_rng(seed + 1)
    losses, pck16, batch_s, step_s = [], 0.0, 0.0, 0.0
    sync = torch.cuda.synchronize if matcher.device.type == "cuda" else (lambda: None)
    t_train = time.perf_counter()
    for i in range(steps):
        t = time.perf_counter()
        b = train_batch(np.random.default_rng(rng.integers(2**63)), batch, res, deformation, device=matcher.device)
        sync()
        t_step = time.perf_counter()
        state, metrics = step(state, b)
        pck16 = max(pck16, float(metrics["train_pck_05_scale_16"]))  # waits for the step
        batch_s += t_step - t
        step_s += time.perf_counter() - t_step
        if i == 0 or i == steps - 1 or (log_every and (i + 1) % log_every == 0):
            losses.append((i + 1, float(metrics["total_loss"])))
            if log_every:
                print(f"step {i + 1}/{steps} loss={losses[-1][1]:.4f} pck16={pck16:.3f}", flush=True)
    train_s = time.perf_counter() - t_train
    mace1, errors1 = benchmark_mace(matcher, bench, num_matches=eval_matches)
    return {"steps": steps, "batch": batch, "eval_pairs": n_eval, "eval_matches": eval_matches,
            "mace_random": mace0, "mace_trained": mace1, "errors_random": errors0,
            "errors_trained": errors1, "first_loss": losses[0][1], "last_loss": losses[-1][1],
            "losses": losses, "best_pck_05_scale_16": pck16, "train_seconds": train_s,
            "batch_seconds": batch_s, "step_seconds": step_s,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--out", default=None, help="write the readings here as JSON")
    args = p.parse_args(argv)
    result = run(args.device, args.steps, args.batch, seed=args.seed, log_every=args.log_every)
    print(json.dumps({k: v for k, v in result.items() if not k.startswith("errors")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
