#!/usr/bin/env python3
"""Write the Orbax fixtures of `tests/test_torch_orbax.py` and `chip_smoke.py`.

    JAX_PLATFORMS=cpu python scripts/make_orbax_fixtures_torch.py [--out tests/data/orbax]

Both are written by the JAX package and orbax themselves, so the port's
reader (`gfnet_tpu_torch/utils/orbax.py`) is held to what orbax really
writes:

  - `tiny_run/tinyset/step_000000002/`: `gfnet_tpu.train.checkpoint.Checkpointer.save`
    of a `tiny_test_config` `TrainState` (the head of `GFNetMatcher(cfg, seed=0)`,
    `TrainConfig(total_pairs=48, ckpt_every_pairs=24)`, global batch 8) after
    two optax updates from fed gradients (seeded numpy; global norms 0.004,
    0.03 and 0.007 about the 0.01 clip) and running statistics moved by
    seeded noise. Beside it, `tiny_run.npz`: every leaf as orbax restores it
    (`leaf/<path>`), the third fed gradient (`grad3/<path>`), JAX's parameters
    after the third update (`params3/<path>`) and the training config
    (`config/*`).
  - `flagship_head/`: `orbax.checkpoint.StandardCheckpointer().save` of
    {params, batch_stats} of `workspace/trained_head_flagship_r5b.npz`, as
    the JAX package's `load_head_checkpoint` restores a head; that `.npz` is
    its expected value. Like every Orbax head it carries no
    `__protocol_kv_norm__` (r5b was trained with k/v standardization on).

Needs JAX and orbax; the files are committed, so nothing else needs them.
The versions used are written into `<out>/README`.
"""

from __future__ import annotations

import argparse
import importlib.metadata
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD_NPZ = os.path.join(ROOT, "workspace", "trained_head_flagship_r5b.npz")
TRAIN_CFG = dict(total_pairs=48, ckpt_every_pairs=24, grad_clip_norm=0.01)
GLOBAL_BATCH = 8
GRAD_NORMS = (0.004, 0.03, 0.007)


def _items(tree):
    if hasattr(tree, "_asdict"):  # optax's states are named tuples
        return tree._asdict().items()
    return tree.items() if hasattr(tree, "items") else enumerate(tree)


def flat(tree, prefix=""):
    """Leaves by "/"-joined path, as orbax names them: a tuple's entries by
    position, a named tuple's by field name."""
    out = {}
    for k, v in _items(tree):
        name = f"{prefix}{k}"
        if v is None:
            continue
        if hasattr(v, "items") or isinstance(v, (tuple, list)):
            out.update(flat(v, name + "/"))
        else:
            out[name] = np.asarray(v)
    return out


def fed_gradient(rng: np.random.Generator, params, norm: float):
    leaves, treedef = jax.tree_util.tree_flatten(params)
    g = [rng.normal(0, 1, np.shape(x)).astype(np.float32) for x in leaves]
    total = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g))
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x * (norm / total)) for x in g])


def tiny_run(out: str) -> list[str]:
    from gfnet_tpu.config import TrainConfig, tiny_test_config
    from gfnet_tpu.matcher.api import GFNetMatcher
    from gfnet_tpu.train.checkpoint import Checkpointer
    from gfnet_tpu.train.state import create_train_state

    rng = np.random.default_rng(0)
    head_vars = GFNetMatcher(tiny_test_config(), seed=0).head_vars
    state = create_train_state(head_vars, TrainConfig(**TRAIN_CFG), GLOBAL_BATCH)
    grads = [fed_gradient(rng, state.params, n) for n in GRAD_NORMS]
    for g in grads[:2]:
        stats = jax.tree_util.tree_map(
            lambda s: s + jnp.asarray(rng.uniform(0, 0.5, np.shape(s)).astype(np.float32)),
            state.batch_stats)
        state = state.apply_gradients(g, stats)
    root = os.path.join(out, "tiny_run")
    shutil.rmtree(root, ignore_errors=True)
    Checkpointer(root, "tinyset").save(state)
    saved = {"step": state.step, "params": state.params, "batch_stats": state.batch_stats,
             "opt_state": state.opt_state}
    third = state.apply_gradients(grads[2], state.batch_stats)
    arrays = {f"leaf/{k}": v for k, v in flat(saved).items()}
    arrays.update({f"grad3/{k}": v for k, v in flat(grads[2]).items()})
    arrays.update({f"params3/{k}": v for k, v in flat(third.params).items()})
    arrays.update({f"config/{k}": np.asarray(v) for k, v in TRAIN_CFG.items()})
    arrays["config/global_batch"] = np.asarray(GLOBAL_BATCH)
    np.savez(os.path.join(out, "tiny_run.npz"), **arrays)
    return [f"tiny_run/tinyset/step_{int(state.step):09d}/: step {int(state.step)}, "
            f"{sum(1 for k in arrays if k.startswith('leaf/'))} leaves",
            f"tiny_run.npz: {len(arrays)} arrays"]


def flagship_head(out: str) -> list[str]:
    tree: dict = {}
    with np.load(HEAD_NPZ) as raw:
        for name in raw.files:
            if name == "__protocol_kv_norm__":
                continue
            d = tree
            *parents, leaf = name.split("/")
            for k in parents:
                d = d.setdefault(k, {})
            d[leaf] = jnp.asarray(raw[name], jnp.float32)
    path = os.path.abspath(os.path.join(out, "flagship_head"))
    shutil.rmtree(path, ignore_errors=True)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree)
    ckptr.wait_until_finished()
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    return [f"flagship_head/: {{params, batch_stats}} of {os.path.relpath(HEAD_NPZ, ROOT)}, "
            f"{size} bytes"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data", "orbax"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    lines = tiny_run(args.out) + flagship_head(args.out)
    versions = {p: importlib.metadata.version(p)
                for p in ("orbax-checkpoint", "tensorstore", "jax", "flax", "optax")}
    readme = ["Orbax fixtures of tests/test_torch_orbax.py and chip_smoke.py, written by",
              "scripts/make_orbax_fixtures_torch.py with "
              + ", ".join(f"{k} {v}" for k, v in versions.items()) + ":", ""]
    readme += [f"  {line}" for line in lines]
    with open(os.path.join(args.out, "README"), "w") as f:
        f.write("\n".join(readme) + "\n")
    print("\n".join(readme))


if __name__ == "__main__":
    main()
