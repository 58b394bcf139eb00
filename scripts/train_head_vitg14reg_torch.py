"""Train the GFNet head for the seeded DINOv2 ViT-g/14-reg backbone on the card.

    python3 scripts/train_head_vitg14reg_torch.py --work <dir> [--steps 900] [--out <dir>]

1. The warm start: `workspace/trained_head_flagship_r5b.npz` (trained on
   JAX's seed-0 ViT-L, `__protocol_kv_norm__` on), with the cross-view
   decoder's input projection `crossview/proj/kernel` drawn anew at
   1536 → 64 (lecun normal, truncated at ±2 std, as Flax's `Dense` draws
   it; `torch.Generator().manual_seed(0)`), the rest as it is.
2. The backbone: `portbench/weights_vitreg.vit_state` of the configuration
   (DINOv2's initialisation from seed 0, bf16), written as a `.pth` for the
   CLIs' `--dinov2_weights`.
3. The fine-tune: `gfnet_tpu_torch.cli.train` over synthetic pairs made on
   the card (`eval/synthetic.train_batch`: 448², deformation 0.3 as the
   reference trains (`train.py:82`) and as the record below evaluates),
   r5b's cross-modal share 0.7, uint8 and lr of 6e-5 a sample, constant
   (one cosine epoch longer than the run), batch 8.
4. The trained head back into the `.npz` layout of the warm start (flat
   `params/...`, `batch_stats/...`, the k/v flag), checked bit for bit
   through `utils.convert.load_head_npz`.
5. The record: `cli.test --dataset synthetic` (100 pairs of 448²,
   deformation 0.3, seed 1234, 5000 matches, batch 4: the protocol of
   `workspace/eval_synth_r5b.json`) on the warm start and on the trained
   head, with the fine-tune's steps, losses and wall time.

Writes `<out>/trained_head_vitg14reg.npz` and `<out>/eval_synth_vitg14reg.json`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONFIG = ROOT / "portbench" / "configs" / "gfnet-vitg14-reg.json"
WARM_FROM = ROOT / "workspace" / "trained_head_flagship_r5b.npz"
KV_FLAG = "__protocol_kv_norm__"
PROJ = "params/crossview/proj/kernel"
LR_PER_SAMPLE = 6e-5  # r5b's
DEFORMATION = 0.3


def warm_start(path: Path, d_model: int) -> None:
    """r5b's `.npz` with `PROJ` drawn anew at (d_model, out)."""
    with np.load(WARM_FROM) as raw:
        flat = {k: raw[k] for k in raw.files}
    out = flat[PROJ].shape[1]
    std = math.sqrt(1.0 / d_model) / 0.87962566103423978
    w = torch.nn.init.trunc_normal_(torch.empty(d_model, out), std=std, a=-2 * std, b=2 * std,
                                    generator=torch.Generator().manual_seed(0))
    flat[PROJ] = w.numpy()
    np.savez(path, **flat)


class _Arrays(dict):
    """A dict that `utils.convert._nest` reads as it reads an open `.npz`."""

    @property
    def files(self):
        return list(self)


def head_to_npz(state: dict, template: Path, path: Path) -> None:
    """The port's head state dict → an `.npz` in `template`'s flat Flax
    layout: each leaf of the template filled from the torch tensor the
    weight bridge (`flax_to_torch_head`) maps it to, found by running the
    bridge on a tree of element indices."""
    from gfnet_tpu_torch.utils.convert import _nest, flax_to_torch_head

    with np.load(template) as raw:
        names = [k for k in raw.files if k != KV_FLAG]
        shapes = {k: raw[k].shape for k in names}
        flag = raw[KV_FLAG] if KV_FLAG in raw.files else None
    offsets, n = {}, 0
    for k in names:
        offsets[k], n = n, n + int(np.prod(shapes[k]))
    if n >= 1 << 24:
        raise ValueError("indices above 2**24 do not survive the bridge's float32")
    ids = _Arrays({k: np.arange(offsets[k], offsets[k] + np.prod(shapes[k]), dtype=np.float64).reshape(shapes[k])
                     for k in names})
    index = flax_to_torch_head(_nest(ids))
    if index.keys() != state.keys():
        raise ValueError(f"the head's keys are not the template's: {sorted(set(index) ^ set(state))[:5]}")
    flat_out = np.full(n, np.nan, np.float32)
    for k, idx in index.items():
        flat_out[idx.numpy().astype(np.int64).ravel()] = state[k].detach().float().cpu().numpy().ravel()
    if np.isnan(flat_out).any():
        raise ValueError("a leaf of the template is not reached by the bridge")
    arrays = {k: flat_out[offsets[k]:offsets[k] + int(np.prod(shapes[k]))].reshape(shapes[k]) for k in names}
    if flag is not None:
        arrays[KV_FLAG] = flag
    np.savez(path, **arrays)


def synth_batches(steps: int, seed: int, deformation: float, device: str):
    from gfnet_tpu_torch.eval.synthetic import train_batch

    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield train_batch(np.random.default_rng(rng.integers(2**63)), 8, 448, deformation, cross_modal_frac=0.7,
                          uint8=True, device=device)


def evaluate(head: Path, vit: Path, data: Path) -> dict:
    from gfnet_tpu_torch.cli import test

    t = time.perf_counter()
    results = test.main(["--conf_path", str(CONFIG), "--ckpt_path", str(head), "--dataset", "synthetic",
                         "--data_path", str(data), "--dinov2_weights", str(vit), "--batch", "4"])
    return {**results, "seconds": time.perf_counter() - t}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work", required=True, help="a directory for the backbone's .pth, the data and checkpoints")
    p.add_argument("--out", default="workspace", help="where the head and its record are written")
    p.add_argument("--steps", type=int, default=900)
    p.add_argument("--eval_pairs", type=int, default=100)
    p.add_argument("--seed", type=int, default=17)
    args = p.parse_args(argv)

    from gfnet_tpu_torch.cli import train
    from gfnet_tpu_torch.tools import make_synth_valdir
    from gfnet_tpu_torch.utils.convert import load_head_npz
    from portbench.weights_vitreg import vit_state

    work, out = Path(args.work), Path(args.out)
    work.mkdir(parents=True, exist_ok=True)
    out.mkdir(parents=True, exist_ok=True)
    raw = json.loads(CONFIG.read_text())
    t0 = time.perf_counter()
    warm = work / "warm_start.npz"
    warm_start(warm, raw["dino_cfg"]["d_model"])
    vit = work / "vit.pth"
    torch.save(vit_state(raw["dino_cfg"]), vit)
    setup_s = time.perf_counter() - t0

    ws = work / "ws"
    t = time.perf_counter()
    state = train.main(["--conf_path", str(CONFIG), "--dataset", "synthetic_vitg14reg", "--workspace", str(ws),
                        "--ft", "--ft_ckpt", str(warm), "--dinov2_weights", str(vit),
                        "--total_pairs", str(8 * args.steps), "--ckpt_every", str(8 * args.steps + 8),
                        "--lr_per_sample", str(LR_PER_SAMPLE), "--log_every", "50"],
                       batches=synth_batches(args.steps, args.seed, DEFORMATION, "cuda"))
    train_s = time.perf_counter() - t
    trained = {k: v.detach().float().cpu() for k, v in state.head.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    head = out / "trained_head_vitg14reg.npz"
    head_to_npz(trained, warm, head)
    back, flag = load_head_npz(str(head))
    assert flag and all(torch.equal(back[k], trained[k]) for k in trained), "the .npz is not the trained head"
    log = [json.loads(line) for line in (ws / "metrics.jsonl").read_text().splitlines()]

    data = work / "data"
    make_synth_valdir.main(["--n", str(args.eval_pairs), "--res", "448", "--deformation", "0.3",
                            "--seed", "1234", "--out", str(data)])
    record = {
        "protocol": {"pairs": args.eval_pairs, "deformation": 0.3, "num_matches": 5000, "batch": 4, "seed": 1234,
                     "entry": "python -m gfnet_tpu_torch.cli.test --dataset synthetic --conf_path "
                              "portbench/configs/gfnet-vitg14-reg.json --ckpt_path "
                              "workspace/trained_head_vitg14reg.npz --dinov2_weights <seeded ViT .pth> --batch 4"},
        "training": {"steps": args.steps, "batch": 8, "pairs_per_step": 8, "res": 448, "deformation": DEFORMATION,
                     "cross_modal_frac": 0.7, "uint8": True, "lr_per_sample": LR_PER_SAMPLE,
                     "grad_clip_norm": 0.01, "seed": args.seed, "warm_start": str(WARM_FROM.relative_to(ROOT)),
                     "warm_start_changed": f"{PROJ} drawn anew at ({raw['dino_cfg']['d_model']}, 64)",
                     "entry": "python3 scripts/train_head_vitg14reg_torch.py",
                     "setup_seconds": setup_s, "train_seconds": train_s, "seconds_a_step": train_s / args.steps,
                     "loss": [(int(m["step"]) // 8 if "step" in m else None, m.get("total_loss")) for m in log]},
        "head_sha256": hashlib.sha256(head.read_bytes()).hexdigest(),
        "device": torch.cuda.get_device_name(0),
        "warm_start_synthetic": evaluate(warm, vit, data),
        "synthetic": evaluate(head, vit, data),
    }
    (out / "eval_synth_vitg14reg.json").write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps({k: record[k] for k in ("head_sha256", "synthetic", "warm_start_synthetic")}))
    return record


if __name__ == "__main__":
    main()
