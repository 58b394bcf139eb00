"""Why one uint8 level moves a pair's ACE by several px (CPU, tiny config).

The port's `eval_pairs` (tensor ops) and the JAX package's `eval_pairs`
rounded to uint8 (what `tools/make_synth_valdir.py` writes) differ by one
level on a few pixels. This script puts both pair sets through the port's
tiny matcher with the trained tiny head and prints, for each pair:

  - how many pixels differ, and how far the warp and certainty move;
  - the certainty draw's candidates under one key: the share found in both
    sets and the share at the same position (the balanced draw and RANSAC
    address positions, so a reordered set is a fresh draw);
  - ACE over `--keys` keys of the benchmark's serial chain on both sets, so
    that the difference between the sets can be set beside the spread one
    set shows over keys alone.

    JAX_PLATFORMS=cpu python scripts/pair_swing_torch.py [--pairs 4] [--keys 8]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", type=int, default=4)
    p.add_argument("--keys", type=int, default=8)
    p.add_argument("--matches", type=int, default=500)
    args = p.parse_args(argv)

    from gfnet_tpu.eval.synthetic import eval_pairs as jax_eval_pairs
    from gfnet_tpu_torch.config import tiny_test_config
    from gfnet_tpu_torch.eval.benchmark import evaluate_pair
    from gfnet_tpu_torch.eval.synthetic import eval_pairs
    from gfnet_tpu_torch.matcher import GFNetMatcher
    from gfnet_tpu_torch.matcher.api import topk_indices
    from gfnet_tpu_torch.utils import jax_init
    from gfnet_tpu_torch.utils.convert import load_head_npz

    head, kv_norm = load_head_npz(os.path.join(ROOT, "workspace", "trained_head_tiny.npz"))
    m = GFNetMatcher(tiny_test_config().with_kv_norm(kv_norm), device="cpu", dtype=torch.float32,
                     head_state=head)
    to_u8 = lambda x: (np.clip(x, 0, 1) * 255).round().astype(np.uint8)
    jax_pairs = [{"im_A": to_u8(q["im_A"]), "im_B": to_u8(q["im_B"]), "H_s2t": q["H_s2t"]}
                 for q in jax_eval_pairs(args.pairs, 112, 0.3, seed=1234)]
    port_pairs = eval_pairs(args.pairs, 112, 0.3, seed=1234, device="cpu")
    as_float = lambda x: torch.as_tensor(np.asarray(x)).float() / 255
    for i, (jp, tp) in enumerate(zip(jax_pairs, port_pairs)):
        differ = sum(int((np.asarray(jp[k]) != np.asarray(tp[k])).sum()) for k in ("im_A", "im_B"))
        (wj, cj), (wt, ct) = (m.match(as_float(q["im_A"]), as_float(q["im_B"])) for q in (jp, tp))
        cert = [torch.where(c > m.cfg.sample_thresh, torch.ones_like(c), c).reshape(-1) for c in (cj, ct)]
        n = cert[0].numel()
        n_good, _ = m._sample_sizes(n, args.matches)
        u, _, _ = m._draws([jax_init.prng_key(3)], [], n, args.matches)
        idx = [topk_indices(torch.log(c.clamp_min(1e-30)) - torch.log(-torch.log(u[0])), n_good)
               for c in cert]
        in_both = len(set(idx[0].tolist()) & set(idx[1].tolist())) / n_good
        same_pos = float((idx[0] == idx[1]).float().mean())
        errors = {"jax": [], "port": []}
        key = jax_init.prng_key(0)
        for _ in range(args.keys):
            key, k = jax_init.split(key)
            for name, q in (("jax", jp), ("port", tp)):
                errors[name].append(evaluate_pair(m, q["im_A"], q["im_B"], q["H_s2t"], key=k,
                                                  num_matches=args.matches)[0])
        print(f"pair {i}: {differ} pixels differ; warp moves {float((wj - wt).abs().max()):.2e}, "
              f"certainty {float((cj - ct).abs().max()):.2e}; of {n_good} candidates "
              f"{in_both:.4f} in both sets, {same_pos:.4f} at the same position")
        for name in ("jax", "port"):
            e = errors[name]
            print(f"   {name} pairs, ACE px over {args.keys} keys: first {e[0]:.3f}, "
                  f"{min(e):.2f}-{max(e):.2f}")


if __name__ == "__main__":
    main()
