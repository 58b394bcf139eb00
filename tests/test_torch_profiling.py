"""`gfnet_tpu_torch/utils/profiling.py`'s card peaks, `bound()`, timer and
trace on the CPU. Its recorder is `test_torch_tracing.py`'s."""

import json

import pytest
import torch

from gfnet_tpu_torch.utils import profiling
from torch_cpu import one_thread  # noqa: F401


def test_bound_takes_the_larger_term():
    assert (profiling.PEAK_BF16_FLOPS, profiling.PEAK_F32_FLOPS, profiling.PEAK_BYTES) == (989e12, 67e12, 3.35e12)
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
