"""The plain PyTorch versions of the two CUDA kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_oneshot_attention.py and tests/test_pallas.py run them.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda_kernels.py.
"""

import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfnet_tpu.ops.pallas.local_corr import local_correlation_pallas
from gfnet_tpu.ops.pallas.oneshot_attention import oneshot_attention
from gfnet_tpu_torch.ops import kernels
from gfnet_tpu_torch.ops.attention import entropy_invariant_scale, fused_attention, scaled_dot_product_attention
from gfnet_tpu_torch.ops.local_correlation import _local_correlation_patch, local_correlation


def T(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("b,n,h,d,scale", [
    (2, 130, 3, 64, None),          # ragged kv: the Pallas kernel pads 130 → 256 and masks
    (1, 200, 2, 8, entropy_invariant_scale(8, 200, 64)),  # cross-view head dim, custom scale
    (2, 96, 2, 16, 0.3),
])
def test_sdpa_matches_oneshot_pallas(b, n, h, d, scale):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, (b, n, h, d)).astype(np.float32) for _ in range(3))
    want = oneshot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, interpret=True)
    got = scaled_dot_product_attention(T(q), T(k), T(v), scale)
    # float32 both sides; the kernel divides by the row sum after PV
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_sdpa_matches_oneshot_pallas_kv_longer_than_q():
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (1, 40, 2, 8)).astype(np.float32)
    k, v = (rng.normal(0, 1, (1, 150, 2, 8)).astype(np.float32) for _ in range(2))
    want = oneshot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.5, interpret=True)
    np.testing.assert_allclose(scaled_dot_product_attention(T(q), T(k), T(v), 0.5).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)


def test_fused_attention_takes_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    q, k, v = (T(rng.normal(0, 1, (1, 33, 2, 8))) for _ in range(3))
    before = kernels.launch_counts()
    torch.testing.assert_close(fused_attention(q, k, v, 0.4), scaled_dot_product_attention(q, k, v, 0.4))
    assert kernels.launch_counts() == before


# -------------------------------------------------------- local correlation
@pytest.mark.parametrize("radius,g,h,c", [(1, 4, 6, 8), (2, 8, 8, 8), (3, 8, 14, 16)])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_local_corr_patch_matches_pallas(radius, g, h, c, storage):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, g, g, c)).astype(np.float32)
    t = rng.standard_normal((2, h, h, c)).astype(np.float32)
    fl = rng.uniform(-1.3, 1.3, (2, g, g, 2)).astype(np.float32)
    jdt = jnp.bfloat16 if storage == "bfloat16" else jnp.float32
    want = local_correlation_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(fl), radius, True, jdt)
    tdt = getattr(torch, storage)
    got = _local_correlation_patch(T(q, tdt), T(t, tdt), T(fl), radius)
    # both sides see the same storage-rounded values and accumulate in float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("value", [5.0, -7.0, math.nan, math.inf])
def test_local_corr_out_of_range_and_nonfinite_flow_is_zero(value):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 4, 4, 8)).astype(np.float32)
    t = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    fl = np.full((1, 4, 4, 2), value, np.float32)
    got = _local_correlation_patch(T(q), T(t), T(fl), 2)
    want = local_correlation_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(fl), 2, True)
    assert torch.count_nonzero(got) == 0
    np.testing.assert_array_equal(np.asarray(want), 0.0)


def test_local_correlation_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    q, t = T(rng.standard_normal((1, 5, 5, 4))), T(rng.standard_normal((1, 9, 9, 4)))
    fl = T(rng.uniform(-1, 1, (1, 5, 5, 2)))
    before = kernels.launch_counts()
    torch.testing.assert_close(local_correlation(q, t, fl, 2), _local_correlation_patch(q, t, fl, 2))
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("fn,args", [
    (kernels.oneshot_attention, lambda: (torch.zeros(1, 4, 1, 8),) * 3 + (0.5,)),
    (kernels.local_corr, lambda: (torch.zeros(1, 2, 2, 4), torch.zeros(1, 3, 3, 4), torch.zeros(1, 2, 2, 2), 1)),
])
def test_kernel_wrappers_refuse_cpu_tensors(fn, args):
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args())


# ------------------------------------------------------------------- build
FAKE_NVCC = """#!{python}
import os, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
src = next((a for a in args if a.endswith(".cu")), None)
if src and os.environ.get("FAKE_NVCC_FAIL", "-") in src:
    sys.exit("error: " + src)
with open(out, "w") as f:
    f.write(" ".join(args))
"""


@pytest.mark.parametrize("fail", [None, "local_corr"])
def test_build_compiles_each_source_into_the_hashed_dir(tmp_path, monkeypatch, fail):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{nvcc.parent}:{os.environ['PATH']}")
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "_build")
    out_dir = kernels.BUILD_ROOT / kernels._source_hash()
    if fail:
        monkeypatch.setenv("FAKE_NVCC_FAIL", fail)
        with pytest.raises(RuntimeError, match="nvcc failed on local_corr.cu"):
            kernels._build(out_dir)
        assert not (out_dir / kernels.LIB_NAME).exists()
        return
    kernels._build(out_dir)
    link = (out_dir / kernels.LIB_NAME).read_text()
    assert "-shared" in link and all(f"{name[:-3]}.{os.getpid()}.o" in link for name in kernels.SOURCES)
    assert all(f"== {name}" in (out_dir / "build.log").read_text() for name in kernels.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in (out_dir / f"oneshot_attention.{os.getpid()}.o").read_text()
