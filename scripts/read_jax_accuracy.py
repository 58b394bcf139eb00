"""The JAX package's accuracy on the pairs the port's accuracy gate uses.

Makes the first `--n` pairs of each synthetic set (`eval_pairs(n, 448, 0.3,
seed=1234)`, same-modal and cross-modal) with the port's tensor-op
`eval_pairs` on the CPU, as uint8, and runs them through the JAX package:
`GFNetMatcher(ModelConfig(), seed=0)` in float32 (its seed-0 random ViT-L,
which the port draws bit for bit with `utils/jax_init.py`), the trained head
`workspace/trained_head_flagship_r5b.npz`, the eval switches of
`gfnet_tpu/cli/test.py` on, and the serial protocol of
`gfnet_tpu/eval/benchmark.HomographyBenchmark.run` (one key split a pair,
5000 matches). Writes the per-pair ACE, MACE and AUCs of each set to
`--out`, which `chip_smoke.py`'s accuracy phase compares with the port on
the card. Needs JAX and a few GB of host memory; ~30-40 s a pair on an
8-core CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/read_jax_accuracy.py --n 16
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DEFAULT_OUT = os.path.join(ROOT, "gfnet_tpu_torch", "eval", "jax_accuracy_r5b.json")
HEAD = "workspace/trained_head_flagship_r5b.npz"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--out", type=str, default=DEFAULT_OUT)
    args = p.parse_args(argv)

    import flax
    import jax
    import jax.numpy as jnp

    from gfnet_tpu.config import ModelConfig
    from gfnet_tpu.eval.benchmark import auc, evaluate_pair
    from gfnet_tpu.matcher.api import GFNetMatcher
    from gfnet_tpu.utils.convert import load_head_checkpoint
    from gfnet_tpu_torch.eval.synthetic import eval_pairs

    cfg = ModelConfig().replace(symmetric=True, upsample_preds=True, attenuate_cert=True)
    t0 = time.perf_counter()
    matcher = GFNetMatcher(cfg, seed=0, dtype=jnp.float32)
    matcher.head_vars = load_head_checkpoint(os.path.join(ROOT, HEAD), matcher.head_vars)
    setup_s = time.perf_counter() - t0
    out = {"jax": jax.__version__, "flax": flax.__version__, "dtype": "float32",
           "backbone": "GFNetMatcher(ModelConfig(), seed=0): init_params(PRNGKey(0)), "
                       "jax_threefry_partitionable=" + str(jax.config.jax_threefry_partitionable),
           "head": HEAD, "kv_norm": os.environ.get("GFNET_KV_NORM"),
           "pairs": f"gfnet_tpu_torch.eval.synthetic.eval_pairs({args.n}, 448, 0.3, seed=1234, "
                    "cross_modal=..., device='cpu'), uint8, /255 as the val dataset reads PNGs",
           "protocol": "serial HomographyBenchmark.run: key = PRNGKey(0), one split a pair, "
                       "num_matches 5000, ACE capped at 70 px",
           "command": "JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/read_jax_accuracy.py "
                      f"--n {args.n}",
           "host": f"{platform.machine()}, {os.cpu_count()} CPUs", "setup_s": setup_s, "sets": {}}
    for cross_modal in (False, True):
        pairs = eval_pairs(args.n, 448, 0.3, seed=1234, cross_modal=cross_modal, device="cpu")
        key = jax.random.PRNGKey(0)
        aces, secs = [], []
        for i, s in enumerate(pairs):
            key, k = jax.random.split(key)
            a = s["im_A"].numpy().astype(np.float32) / 255.0
            b = s["im_B"].numpy().astype(np.float32) / 255.0
            ace, rt = evaluate_pair(matcher, a, b, s["H_s2t"], key=k)
            aces.append(ace)
            secs.append(rt)
            print(f"{pairs.dataset} pair {i}: ACE {ace:.4f} px, {rt:.1f} s", flush=True)
        thresholds = (3, 5, 10, 20)
        out["sets"][pairs.dataset] = {
            "ace": aces, "mace": float(np.mean(aces)),
            **{f"auc@{t}": v for t, v in zip(thresholds, auc(aces, thresholds))},
            "seconds_per_pair": secs}
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "seconds_per_pair"}
                      for k, v in out["sets"].items()}))


if __name__ == "__main__":
    main()
