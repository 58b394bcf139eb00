"""The work counts against values worked by hand."""

import json

import pytest

from conftest import DATA, ROOT

from portbench import work

TINY = json.loads((DATA / "tiny.json").read_text())
BASIC = json.loads((ROOT / "portbench" / "configs" / "gfnet-basic.json").read_text())
MAP = json.loads((ROOT / "portbench" / "configs" / "gfnet-map.json").read_text())


def test_tiny_attention_calls():
    calls = work.attention_calls(TINY, 1)
    # the ViT's 2 blocks and the decoder's 1 block at 112 (8 x 8 patches) and 168 (12 x 12)
    assert calls == [work.Attention(2, 65, 65, 2, 16)] * 2 + [work.Attention(2, 64, 64, 2, 8)] + \
        [work.Attention(2, 145, 145, 2, 16)] * 2 + [work.Attention(2, 144, 144, 2, 8)]
    assert calls[0].flops == 4 * 2 * 2 * 65 * 65 * 16 == 1_081_600
    assert calls[0].bytes == 2 * 2 * 2 * 16 * (2 * 65 + 2 * 65) == 33_280


def test_tiny_local_correlation_calls():
    calls = work.local_corr_calls(TINY, 1)
    assert calls == [work.LocalCorr(2, 8, 8, 8, 16, 2), work.LocalCorr(2, 8, 14, 14, 16, 2),
                     work.LocalCorr(2, 16, 28, 28, 8, 1), work.LocalCorr(2, 32, 56, 56, 8, 1),
                     work.LocalCorr(2, 12, 21, 21, 16, 2), work.LocalCorr(2, 24, 42, 42, 8, 1),
                     work.LocalCorr(2, 48, 84, 84, 8, 1)]
    c = calls[0]
    assert c.flops == 128 * (2 * 36 * 16 + 7 * 25) == 169_856
    assert c.bytes == 2 * 128 * 16 + 2 * 2 * 8 * 8 * 16 + 4 * 128 * 2 + 4 * 128 * 25 == 22_016


def test_num_itr_doubles_the_refiners_only():
    assert len(work.local_corr_calls(MAP, 8)) == 2 * len(work.local_corr_calls(BASIC, 8)) == 14
    assert work.attention_calls(MAP, 8) == work.attention_calls(BASIC, 8)
    assert work.model_flops(MAP, 8, 5000) > work.model_flops(BASIC, 8, 5000)


def test_vit_l_at_448():
    patch = 2 * 1024 * 588 * 1024
    block = 2 * 1025 * 1024 * 3072 + 4 * 1025 * 1025 * 1024 + 2 * 1025 * 1024 * 1024 + 2 * 2 * 1025 * 1024 * 4096
    assert work._vit_flops(BASIC, 448) == patch + 24 * block == 723_593_035_776


def test_a_pair_of_the_published_model():
    # both views through the ViT at 448 and 560 dominate: about 3.98 TFLOP a pair
    assert work.model_flops(BASIC, 1, 5000) == pytest.approx(3.983e12, rel=1e-3)
    assert work.model_flops(BASIC, 8, 5000) == pytest.approx(8 * work.model_flops(BASIC, 1, 5000))


def test_least_time_takes_the_larger_bound():
    assert work.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)
