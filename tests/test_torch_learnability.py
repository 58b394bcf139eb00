"""The port learns: the twin of `tests/test_learnability.py` through
`gfnet_tpu_torch/eval/learnability.py`, on the CPU.

The tiny config from seed 0 (the JAX package's own draw of ViT and head),
70 steps of 8 synthetic pairs made with tensor ops, then the benchmark on 6
held-out pairs at 1000 matches: the loss must fall, the coarse flow learn,
and the MACE drop decisively off the random weights' ~70 px cap. The card
runs the 500-step version (`chip_smoke.py`, phase `learn`). Several minutes
on the CPU, so `slow`.
"""

import pytest

from gfnet_tpu_torch.eval.learnability import run
from torch_cpu import one_thread  # noqa: F401


@pytest.mark.slow
def test_short_training_run_beats_random_baseline():
    r = run(device="cpu", steps=70, n_eval=6, eval_matches=1000)
    assert r["mace_random"] > 40.0, r["mace_random"]
    assert r["last_loss"] < 0.85 * r["first_loss"], (r["first_loss"], r["last_loss"])
    assert r["best_pck_05_scale_16"] > 0.2, r["best_pck_05_scale_16"]
    assert r["mace_trained"] < r["mace_random"] - 10.0, (r["mace_random"], r["mace_trained"])
