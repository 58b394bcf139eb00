"""`correct` on the CPU at tiny size: true for the program as it is, false
for the control and for each fault an inference cell can have."""

import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT

from portbench.control import readings
from portbench.run import run_cell


def run(cell, seed=7):
    return run_cell(cell, seed, 0.5, False, "cpu", time.perf_counter())


def test_a_sound_run_is_correct(tiny_cell):
    result = run(tiny_cell)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"pairs_per_s", "setup_s"}


def test_half_of_the_batch_left_out(tiny_cell, monkeypatch):
    from gfnet_tpu_torch.matcher import GFNetMatcher

    match = GFNetMatcher._match_batch

    def half(self, a, b, corr_mesh=None):
        n = (a.shape[0] + 1) // 2
        warp, cert = match(self, a[:n], b[:n], corr_mesh)
        return torch.cat([warp, warp])[:a.shape[0]], torch.cat([cert, cert])[:a.shape[0]]

    monkeypatch.setattr(GFNetMatcher, "_match_batch", half)
    result = run(tiny_cell)
    assert not result["correct"]
    assert result["checks"]["warp_px"]["value"] > result["checks"]["warp_px"]["limit"]


def test_an_answer_altered_where_it_is_produced(tiny_cell, monkeypatch):
    from gfnet_tpu_torch.matcher import GFNetMatcher

    solve = GFNetMatcher._solve

    def shifted(self, *args):
        H = solve(self, *args)
        return torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=H.dtype) @ H

    monkeypatch.setattr(GFNetMatcher, "_solve", shifted)
    result = run(tiny_cell)
    assert not result["correct"]
    assert result["checks"]["solve_px"]["value"] > result["checks"]["solve_px"]["limit"]


def test_the_control_is_not_correct(tiny_cell):
    lines = []
    summary = readings(tiny_cell, [5], [201, 202, 203], 0.5, "cpu", lines.append)
    for line in lines:
        if line["side"] == "control":
            assert any(c["value"] > c["limit"] for c in line["checks"].values()), line
        else:
            assert all(c["value"] <= c["limit"] for c in line["checks"].values()), line
    assert summary["solve_px"]["control_min"] > summary["solve_px"]["limit"]


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "basic-serve-b1", "--seed", "1",
                           "--seconds", "1"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card(card):
    from portbench import spec

    lines = []
    readings(spec.load_cell("basic-serve-b1"), [2147483647], [2147483649], 7.0, card, lines.append)
    control = [line for line in lines if line["side"] == "control"]
    assert control and all(any(c["value"] > c["limit"] for c in line["checks"].values()) for line in control)
    sound = [line for line in lines if line["side"] == "program"]
    assert sound and all(all(c["value"] <= c["limit"] for c in line["checks"].values()) for line in sound)
