"""Percentiles, rates and the device's busy and idle time on made-up events."""

import numpy as np
import pytest

from portbench import spec, stats, trace


def test_percentile_is_numpys_linear_one():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 300):
        xs = list(rng.exponential(size=n))
        for q in (0, 50, 95, 100):
            assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_union_busy_and_gaps_with_a_stall():
    ops = [(0.0, 1.0), (0.5, 2.0), (5.0, 6.0), (9.5, 12.0)]
    assert stats.union(ops, 0.0, 10.0) == [(0.0, 2.0), (5.0, 6.0), (9.5, 10.0)]
    assert stats.busy(ops, 0.0, 10.0) == pytest.approx(3.5)
    assert stats.gaps(ops, 0.0, 10.0) == [(2.0, 5.0), (6.0, 9.5)]


def record(ops):
    """A traced record of two calls of 8 pairs over [0, 1000] µs."""
    calls = [{"name": "call", "start": 0.0, "end": 500.0, "pairs": 8},
             {"name": "call", "start": 500.0, "end": 1000.0, "pairs": 8}]
    spans = [{"name": "vit", "start": 10.0, "end": 100.0}, {"name": "head", "start": 100.0, "end": 300.0},
             {"name": "refiner.8", "start": 150.0, "end": 200.0},
             {"name": "vit", "start": 510.0, "end": 600.0}, {"name": "head", "start": 600.0, "end": 800.0}]
    return {"trace": {"ops": ops, "spans": spans, "calls": calls, "window": (0.0, 1000.0)},
            "calls": [(0.0, 0.5, 8), (0.5, 1.0, 8), (1.0, 2.0, 7)], "window_start": 0.0, "setup_s": 3.0}


def op(name, start, end, launch):
    return {"name": name, "kind": "kernel", "start": start, "end": end, "launch": launch}


OPS = [op("void (anonymous namespace)::oneshot_attention_wgmma_kernel<64>(int)", 20.0, 120.0, 15.0),
       op("gemm", 130.0, 180.0, 120.0),
       op("void (anonymous namespace)::local_corr_kernel<float, 8>(int)", 190.0, 210.0, 160.0),
       op("topk", 320.0, 420.0, 310.0),   # after the head: sampling
       op("gemm", 520.0, 620.0, 520.0),
       op("solve", 900.0, 950.0, 850.0)]  # a stall from 620 to 900


def test_readers_on_a_record_with_a_stall(tiny_cell):
    rec = record(OPS)
    read = lambda name: spec.metric(name).read(rec, tiny_cell)
    assert read("device_idle_share.batch") == pytest.approx(100.0 * (1 - 420.0 / 1000.0))
    assert read("launches_per_pair.serve") == pytest.approx(6 / 16)
    assert read("vit_ms.batch") == pytest.approx((100.0 + 100.0) * 1e-3 / 2)
    assert read("refiner_ms.batch") == pytest.approx(20.0 * 1e-3 / 2)
    assert read("sample_solve_ms.batch") == pytest.approx((100.0 + 50.0) * 1e-3 / 2)
    assert read("pairs_per_s") == pytest.approx(23 / 2.0)
    assert read("latency_p50_ms") == pytest.approx(500.0)
    assert read("latency_p95_ms") == pytest.approx(stats.percentile([500.0, 500.0, 1000.0], 95))
    assert read("setup_s") == 3.0
    assert trace.busy_seconds(rec["trace"]) == pytest.approx(420e-6)


def test_readers_return_nothing_where_nothing_ran(tiny_cell):
    rec = record([])
    for name in ("device_idle_share.batch", "launches_per_pair.serve", "vit_ms.batch", "refiner_ms.batch",
                 "sample_solve_ms.batch", "k1_roofline", "k2_roofline"):
        assert spec.metric(name).read(rec, tiny_cell) is None


def test_roofline_shares_count_the_configuration_s_work(tiny_cell):
    from portbench import work

    rec = record(OPS)
    k1 = spec.metric("k1_roofline").read(rec, tiny_cell)
    least = sum(work.least_seconds(a.flops, a.bytes) for a in work.attention_calls(tiny_cell.config, 1))
    assert k1 == pytest.approx(100.0 * least * 16 / 100e-6)
    assert spec.metric("k2_roofline").read(rec, tiny_cell) > 0


def test_kernel_names():
    assert trace.kernel_name(OPS[0]["name"]) == "oneshot_attention_wgmma_kernel"
    assert trace.kernel_name(OPS[2]["name"]) == "local_corr_kernel"
    assert trace.kernel_name("void at::native::vectorized_elementwise_kernel<4, F>(int, F)") == \
        "vectorized_elementwise_kernel"
    assert trace.kernel_name("nvjet_tst_256x144_64x4_1x2_h_bz_coopA_bias_TNT") == \
        "nvjet_tst_256x144_64x4_1x2_h_bz_coopA_bias_TNT"


def test_breakdown_names_the_stall():
    spans = record(OPS)["trace"]["spans"]
    cpu = [(600.0, 900.0, "aten::_local_scalar_dense")]
    b = trace._breakdown(OPS, spans, cpu, (0.0, 1000.0))
    assert b["idle_gaps"][0] == ["head/aten::_local_scalar_dense", pytest.approx(280e-6)]
    assert b["device_ops"][0][1] == pytest.approx(150e-6)
