"""The `homography_vitreg` driver on the CPU at tiny size: `vit_rel` beside
the three numbers, small for the program as it is and over its limit for a
ViT that drops cls alone (the register tokens come out as patches)."""

import time

import pytest
import torch

from portbench import spec
from portbench.run import run_cell


@pytest.fixture
def tiny_register_cell(tiny_cell):
    config = {**tiny_cell.config, "limits": {**tiny_cell.config["limits"], "vit_rel": 0.05}}
    config["dino_cfg"] = {**config["dino_cfg"], "ffn_layer": "swiglufused", "num_register_tokens": 4,
                          "interpolate_antialias": True, "interpolate_offset": 0.0}
    return spec.Cell(name="tiny-reg-b2", chips=1, config=config, mix={**tiny_cell.mix, "kind": "homography_vitreg"},
                     end_to_end=tiny_cell.end_to_end, per_layer=[], root=tiny_cell.root)


def run(cell, seed=7):
    return run_cell(cell, seed, 0.5, False, "cpu", time.perf_counter())


def test_a_sound_run_reads_its_vit_within_the_limit(tiny_register_cell):
    result = run(tiny_register_cell)
    assert list(result["checks"]) == ["warp_px", "cert_gap", "solve_px", "vit_rel"]
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert 0 < result["checks"]["vit_rel"]["value"] < 0.01


def test_a_vit_that_keeps_its_registers_in_the_output_is_not_correct(tiny_register_cell, monkeypatch):
    from gfnet_tpu_torch.models.vit import VisionTransformer

    forward = VisionTransformer.forward

    def drops_cls_alone(self, x):
        r, norm = self.cfg.num_register_tokens, self.norm.forward
        # out[:, 1 + r:] of the shifted tokens is y[:, 1:1 + n]: registers first
        self.norm.forward = lambda t: (lambda y: torch.cat([y[:, :r], y[:, :-r]], dim=1))(norm(t))
        try:
            return forward(self, x)
        finally:
            del self.norm.forward

    monkeypatch.setattr(VisionTransformer, "forward", drops_cls_alone)
    result = run(tiny_register_cell)
    assert not result["correct"]
    assert result["checks"]["vit_rel"]["value"] > 10 * result["checks"]["vit_rel"]["limit"]
