"""`gfnet_tpu_torch/utils/profiling.py` against the JAX package's
`gfnet_tpu/utils/profiling.py`: the same static cost model (pure arithmetic,
held exactly), timed against the H100's peaks; and its timer and trace on
the CPU."""

import json

import pytest
import torch

from gfnet_tpu.config import ModelConfig as JModelConfig
from gfnet_tpu.config import tiny_test_config as jax_tiny_config
from gfnet_tpu.utils import profiling as jprof
from gfnet_tpu_torch.config import ModelConfig, tiny_test_config
from gfnet_tpu_torch.utils import profiling


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("configs", [(ModelConfig, JModelConfig), (tiny_test_config, jax_tiny_config)],
                         ids=["flagship", "tiny"])
def test_model_op_costs_equal_jax(configs, batch):
    port, jax_cfg = configs
    got = profiling.model_op_costs(port(), batch)
    want = jprof.model_op_costs(jax_cfg(), batch)
    assert [(c.name, c.flops, c.bytes) for c in got] == [(c.name, c.flops, c.bytes) for c in want]


def test_op_cost_times_use_the_cards_peaks():
    cost = profiling.OpCost("x", flops=989e12, bytes=6.7e12)
    assert (profiling.PEAK_BF16_FLOPS, profiling.PEAK_F32_FLOPS, profiling.PEAK_BYTES) == (989e12, 67e12, 3.35e12)
    assert cost.compute_s == 1.0 and cost.memory_s == 2.0 and cost.bound == "memory"
    report = profiling.roofline_report(ModelConfig(), 8).splitlines()
    assert report[0].split() == ["op", "GFLOP", "MB", "t_comp", "t_mem", "bound"]
    assert [line.split()[0] for line in report[1:]] == [c.name for c in profiling.model_op_costs(ModelConfig(), 8)]


def test_bound_takes_the_larger_term():
    ms, by = profiling.bound([(67e9, profiling.PEAK_F32_FLOPS)], 3.35e9)  # 1 ms of operations and of bytes
    assert by in ("operations", "bytes") and ms == pytest.approx(1.0)
    assert profiling.bound([(989e9, profiling.PEAK_BF16_FLOPS), (67e9, profiling.PEAK_F32_FLOPS)], 0.0) == \
        pytest.approx((2.0, "operations"))
    assert profiling.bound([], 3.35e9, exps=3e9, exp_rate=1e12) == pytest.approx((3.0, "exponentials"))


def test_timed_and_trace_run_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    seconds = profiling.timed(torch.matmul, x, x, iters=3, warmup=1)
    assert 0.0 < seconds < 1.0
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.matmul(x, x)
    assert any("matmul" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
