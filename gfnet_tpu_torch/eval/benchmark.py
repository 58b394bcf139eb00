"""ACE/AUC homography benchmark harness.

Counterpart of `gfnet_tpu/eval/benchmark.py`, the reference eval protocol
end to end:
  - `auc` recall-vs-error trapezoid curve (ref `estimation.py:12-24`);
  - per-pair estimation: match → sample 5k → solve → 4-corner transfer error
    capped at 70px (ref `estimation.py:46-92`), with wall-clock runtime of
    match+sample+solve, the device synchronized before the clock stops;
  - a benchmark over any indexable of `{im_A, im_B, H_s2t}` pairs with a
    `.dataset` name (a val `data/dataset.HomographyDataset`, or
    `eval/synthetic.eval_pairs` made on the card) reporting auc@{3,5,10,20} +
    mean ACE + runtime (ref `test.py:57-75`).

Images are float in [0, 1], or uint8, which is divided by 255 as the val
dataset reads a PNG. Randomness takes the JAX package's key chains from
`PRNGKey(seed)` (`gfnet_tpu/eval/benchmark.py:88-120`), so each pair draws
what it draws there: serial, `key, k = split(key)` a pair and the pair
drawing from `split(k, 1)[0]`; batched, the same split a chunk and pair j
of the chunk drawing from `split(k, B)[j]`. `run(..., serial_keys=True)`
batches pairs for speed but hands each pair its serial key, so a batched
run reads what the serial protocol reads.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from gfnet_tpu_torch.utils import jax_init


def auc(errors: Sequence[float], thresholds: Sequence[float]) -> list[float]:
    """Trapezoid AUC of the recall-vs-error curve at each threshold."""
    errors = np.sort(np.asarray(errors, np.float64))
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    out = []
    for t in thresholds:
        last = np.searchsorted(errors, t)
        r = np.r_[recall[:last], recall[last - 1]]
        e = np.r_[errors[:last], t]
        out.append(float(np.trapezoid(r, x=e) / t))
    return out


def corner_error_np(H_pred: np.ndarray, H_gt: np.ndarray, w: int, h: int, cap=70.0) -> float:
    corners = np.array(
        [[0, 0, 1], [0, h - 1, 1], [w - 1, 0, 1], [w - 1, h - 1, 1]], np.float64
    )
    real = corners @ H_gt.T
    real = real[:, :2] / real[:, 2:]
    pred = corners @ H_pred.T
    pred = pred[:, :2] / pred[:, 2:]
    return float(min(np.mean(np.linalg.norm(real - pred, axis=1)), cap))


def unit_image(img) -> torch.Tensor:
    """An image as float32 in [0, 1]: uint8 is divided by 255."""
    t = torch.as_tensor(img)
    return t.float() / 255.0 if t.dtype == torch.uint8 else t.float()


def homography_to_host(H: torch.Tensor) -> np.ndarray:
    if H.device.type == "cuda":  # where the JAX package calls block_until_ready
        torch.cuda.synchronize(H.device)
    return H.cpu().numpy().astype(np.float64)


def _finite_or_degenerate(H: np.ndarray) -> np.ndarray:
    return H if np.all(np.isfinite(H)) else np.diag([0.0, 0.0, 1.0])


def evaluate_pair(matcher, im_src, im_tgt, H_gt: np.ndarray, key=None,
                  num_matches: int = 5000) -> tuple[float, float]:
    """One pair → (ACE, runtime_seconds), drawing under the JAX key `key`.
    Timing covers match+sample+solve like the reference (`estimation.py:56,78`)."""
    a, b = unit_image(im_src), unit_image(im_tgt)
    h, w = a.shape[-3:-1]
    start = time.perf_counter()
    H_pred = matcher.estimate_homography(a, b, num_matches=num_matches, key=key)
    H_pred = homography_to_host(H_pred)
    runtime = time.perf_counter() - start
    return corner_error_np(_finite_or_degenerate(H_pred), np.asarray(H_gt, np.float64), w, h), runtime


class HomographyBenchmark:
    """Loop a val dataset through the matcher (ref
    `MultimodalHomogBenchmark.benchmark`)."""

    def __init__(self, dataset, thresholds=(3, 5, 10, 20)):
        self.dataset = dataset
        self.thresholds = thresholds

    def _results(self, errors: list) -> dict:
        name = self.dataset.dataset
        aucs = auc(errors, self.thresholds)
        results = {f"auc@{t}_{name}": v for t, v in zip(self.thresholds, aucs)}
        results[f"mace_{name}"] = float(np.mean(errors))
        return results

    def run(self, matcher, max_pairs: int | None = None, seed: int = 0, verbose=False,
            batch_size: int | None = None, serial_keys: bool = False) -> dict:
        """batch_size=None: the reference's strictly serial per-pair protocol
        (its runtime number is per-pair latency, `estimation.py:56,78`).
        batch_size=B: pairs go through `estimate_homography_batched` B at a
        time, the ragged tail repeat-padded, with `runtime_*` reporting
        amortized wall-clock per pair; with `serial_keys` each pair draws
        under the serial protocol's key. Each pair's ACE stays in
        `self.errors`, in order."""
        n = len(self.dataset)
        if max_pairs:
            n = min(n, max_pairs)
        self.errors = errors = []
        if batch_size:
            return self._run_batched(matcher, n, batch_size, seed, serial_keys, verbose, errors)
        runtimes = []
        key = jax_init.prng_key(seed)
        for i in range(n):
            sample = self.dataset[i]
            key, k = jax_init.split(key)
            ace, rt = evaluate_pair(matcher, sample["im_A"], sample["im_B"], sample["H_s2t"], key=k)
            errors.append(ace)
            runtimes.append(rt)
            if verbose and (i + 1) % 50 == 0:
                print(f"[{i+1}/{n}] running MACE={np.mean(errors):.3f}")
        results = self._results(errors)
        # first pair includes warm-up; median is the honest steady-state number
        results[f"runtime_{self.dataset.dataset}"] = float(np.median(runtimes))
        return results

    def _run_batched(self, matcher, n: int, bsz: int, seed: int, serial_keys: bool, verbose: bool,
                     errors: list) -> dict:
        batch_times = []
        key = jax_init.prng_key(seed)
        for start in range(0, n, bsz):
            idx = list(range(start, min(start + bsz, n)))
            samples = [self.dataset[i] for i in idx]
            # repeat-pad the ragged tail so every chunk has the same shape
            samples += [samples[-1]] * (bsz - len(idx))
            im_a = torch.stack([unit_image(s["im_A"]) for s in samples])
            im_b = torch.stack([unit_image(s["im_B"]) for s in samples])
            if serial_keys:  # pair i's key of the serial chain, split(k, 1)[0]
                pair_keys = []
                for _ in idx:
                    key, k = jax_init.split(key)
                    pair_keys.append(jax_init.split(k, 1)[0])
                pair_keys += [pair_keys[-1]] * (bsz - len(idx))
                keys = {"pair_keys": np.stack(pair_keys)}
            else:
                key, k = jax_init.split(key)
                keys = {"key": k}
            t0 = time.perf_counter()
            Hs = matcher.estimate_homography_batched(im_a, im_b, **keys)
            Hs = homography_to_host(Hs)
            batch_times.append(time.perf_counter() - t0)
            h, w = im_a.shape[1:3]
            for j in range(len(idx)):
                errors.append(corner_error_np(_finite_or_degenerate(Hs[j]),
                                              np.asarray(samples[j]["H_s2t"], np.float64), w, h))
            if verbose:
                print(f"[{len(errors)}/{n}] running MACE={np.mean(errors):.3f}")
        name = self.dataset.dataset
        results = self._results(errors)
        # amortized per-pair wall-clock; the first chunk carries the warm-up,
        # so it is dropped from the steady-state figure when there are more
        steady = batch_times[1:] or batch_times
        results[f"runtime_{name}"] = float(np.sum(steady) / (len(steady) * bsz))
        results[f"batch_size_{name}"] = bsz
        return results
