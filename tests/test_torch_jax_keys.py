"""The port's sampler, solve and benchmark under the JAX package's keys,
against the JAX package at `tiny_test_config()`, float32 on the CPU, both
packages built from `seed=0` alone (ViT and head drawn by the seed).

The draws are JAX's bit for bit (`tests/test_torch_jax_init.py`). What can
still differ is the Gumbel key log(w) - log(-log(u)) by a unit in the last
place: XLA's CPU `log` is a polynomial of its own, torch's is nearly
correctly rounded (they differ on ~14% of float32 inputs), so two sampled
candidates whose keys lie within a unit of each other may swap places. The
tests hold the rows, the homographies and each pair's ACE to tolerances
stated beside them.

The JAX side runs with GFNET_S2D=0, GFNET_EXACT_TOPK=1 and no
GFNET_KV_NORM. On the CPU, JAX's default `approx_max_k` is the exact top-k
in `lax.top_k`'s order (largest first, ties to the lower index, which the
port's `topk_indices` repeats) for k < N, checked here; at k = N, which the
tiny config reaches at 5000 matches (4 × 5000 candidates of 18432), it
orders the ties among -inf keys otherwise, and the flagship (20000 of
204800) never gets there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfnet_tpu.config import tiny_test_config as jax_tiny_config
from gfnet_tpu.eval import benchmark as jbench
from gfnet_tpu.eval.synthetic import benchmark_mace as jax_benchmark_mace
from gfnet_tpu.matcher.api import GFNetMatcher as JGFNetMatcher
from gfnet_tpu.utils.convert import load_head_checkpoint
from gfnet_tpu_torch.config import tiny_test_config
from gfnet_tpu_torch.core.homography import corner_error
from gfnet_tpu_torch.eval import benchmark as tbench
from gfnet_tpu_torch.eval.synthetic import benchmark_mace, eval_pairs
from gfnet_tpu_torch.matcher import GFNetMatcher
from gfnet_tpu_torch.matcher.api import topk_indices
from gfnet_tpu_torch.utils.convert import load_head_npz

HEAD = "workspace/trained_head_tiny.npz"
RES = 112


@pytest.fixture(scope="module")
def matchers():
    """JAX's and the port's tiny matchers from seed 0, three synthetic pairs
    (uint8 for the port, the same values /255 for JAX) and JAX's warps."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GFNET_S2D", "0")
        mp.setenv("GFNET_EXACT_TOPK", "1")
        mp.delenv("GFNET_KV_NORM", raising=False)
        jm = JGFNetMatcher(jax_tiny_config(), seed=0, dtype=jnp.float32)
        tm = GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32, seed=0)
        pairs = eval_pairs(3, RES, 0.15, seed=1234, device="cpu")
        a = np.stack([p["im_A"].numpy() for p in pairs]).astype(np.float32) / 255.0
        b = np.stack([p["im_B"].numpy() for p in pairs]).astype(np.float32) / 255.0
        warp, cert = jm.match(a, b)
        yield jm, tm, pairs, a, b, np.asarray(warp), np.asarray(cert)


@pytest.mark.parametrize("k", [900, 5000])
def test_topk_order_is_jaxs(k):
    """Ties to the lower index, largest first, as `lax.top_k` returns them,
    and the CPU's `approx_max_k` for k < N: NaN above +inf, +0 above -0,
    -inf last."""
    rng = np.random.default_rng(0)
    x = (rng.integers(-20, 20, 5000) * rng.choice([1.0, 1e-3, 1e30], 5000)).astype(np.float32)
    x[::7] = -np.inf
    x[3::11] = 0.0
    x[5::13] = -0.0
    x[[10, 400]] = np.inf
    x[[20, 300]] = np.nan
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
    np.testing.assert_array_equal(topk_indices(torch.from_numpy(x), k).numpy(), want)
    if k < len(x):
        approx = jax.jit(lambda v: jax.lax.approx_max_k(v, k, recall_target=0.95)[1])
        np.testing.assert_array_equal(np.asarray(approx(jnp.asarray(x))), want)


@pytest.mark.parametrize("num", [300, 2000])
def test_sample_with_one_key_picks_jaxs_rows(matchers, num):
    """`sample(..., key)` against JAX's `sample(..., key)` (its
    `_sample_jit`) on the same warp and certainty. At 300 of 18432 the rows
    are JAX's, in JAX's order; at 2000 (8000 candidates) a sound run moved 6
    rows of 2000 in one pair, the Gumbel keys' last-place ties: at most 1%."""
    jm, tm, _, _, _, warp, cert = matchers
    for i, seed in enumerate((5, 6, 7)):
        key = jax.random.PRNGKey(seed)
        want, want_c = jm.sample(warp[i], cert[i], num, key=key)
        got, got_c = tm.sample(warp[i], cert[i], num, key=np.asarray(key))
        rows = (got.numpy() != np.asarray(want)).any(-1)
        if num == 300:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        assert rows.mean() <= 0.01, (i, int(rows.sum()))


def test_estimate_homography_batched_and_single_with_one_key_match_jax(matchers):
    """B=3 under one key: each pair draws from `split(key, 3)[i]` on both
    sides; the single-pair call from `split(key, 1)[0]`. Corner error between
    the two packages' H, px: a sound run read at most 0.064 (the random
    head's matches are noisy, so a moved row shifts the refit)."""
    jm, tm, _, a, b, _, _ = matchers
    key = jax.random.PRNGKey(11)
    want = np.asarray(jm.estimate_homography_batched(a, b, 2000, key=key))
    got = tm.estimate_homography_batched(a, b, 2000, key=np.asarray(key))
    assert got.shape == (3, 3, 3)
    for i in range(3):
        assert float(corner_error(got[i], torch.from_numpy(want[i]), RES, RES)) < 0.25, i
    want1 = np.asarray(jm.estimate_homography(a[1], b[1], 2000, key=key))
    got1 = tm.estimate_homography(a[1], b[1], 2000, key=np.asarray(key))
    assert float(corner_error(got1, torch.from_numpy(want1), RES, RES)) < 0.25


@pytest.fixture(scope="module")
def trained(matchers):
    """Both matchers with the trained tiny head, so that ACE is a few px, and
    the port's dense matching handed to JAX's `match` on the same images.
    RANSAC's scores are integer inlier counts, so a pair's ACE jumps with
    its inputs: the two forwards differ by up to 2e-4 in float32
    (`tests/test_torch_matcher.py`), and even JAX's own warps of one pair
    matched alone and in a batch (4e-6 apart) read 2.87 and 2.19 px. Fed
    the warps JAX's run sees, the port's sampler and solve see what JAX's
    see, and the tests hold the key chains alone."""
    jm, tm, pairs, a, b, _, _ = matchers
    jm.head_vars = load_head_checkpoint(HEAD, jm.head_vars)
    head_state, _ = load_head_npz(HEAD)
    tm.head.load_state_dict(head_state)
    jax_pairs = [{"im_A": a[i], "im_B": b[i], "H_s2t": p["H_s2t"]} for i, p in enumerate(pairs)]
    tm._match_batch = lambda x, y, corr_mesh=None: tuple(
        torch.from_numpy(np.asarray(t)) for t in jm.match(x.numpy(), y.numpy()))
    yield jm, tm, pairs, jax_pairs
    del tm._match_batch


class _Named(list):
    def __init__(self, name, items):
        super().__init__(items)
        self.dataset = name


def _chain(n):
    """n keys of the serial chain: `key, k = split(key)` from PRNGKey(0)."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(k)
    return out


def _ace(H, pair):
    return jbench.corner_error_np(np.asarray(H, np.float64), np.asarray(pair["H_s2t"], np.float64), RES, RES)


def _jax_errors(jm, jax_pairs, batch_size, serial_keys):
    """Each pair's ACE under JAX's protocol. Serial and batched (chunks of
    2, the tail repeat-padded, one chain key a chunk) are the JAX package's
    own `HomographyBenchmark.run`, its per-pair errors read as it computes
    them; batched chunks with each pair solved under its serial key are
    made here from JAX's `match` and `_sample_solve_batched_jit`.
    Returns (errors, the JAX run's MACE or None)."""
    if not serial_keys:
        errors, real = [], jbench.corner_error_np
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jbench, "corner_error_np", lambda *a: errors.append(real(*a)) or errors[-1])
            ref = jbench.HomographyBenchmark(_Named("s", jax_pairs)).run(jm, batch_size=batch_size)
        assert len(errors) == len(jax_pairs)
        return errors, ref["mace_s"]
    errors, serial = [], iter(_chain(len(jax_pairs)))
    for start in range(0, len(jax_pairs), batch_size):
        chunk = jax_pairs[start:start + batch_size]
        padded = chunk + [chunk[-1]] * (batch_size - len(chunk))
        warp, cert = jm.match(np.stack([p["im_A"] for p in padded]), np.stack([p["im_B"] for p in padded]))
        errors += [_ace(jm._sample_solve_batched_jit(warp[j:j + 1], cert[j:j + 1], 5000, next(serial),
                                                     (RES, RES), (RES, RES))[0], p)
                   for j, p in enumerate(chunk)]
    return errors, None


# per-pair |ACE port - ACE JAX|, px, on the same warps and keys: the solves
# agree to float32 rounding; sound runs read at most 2e-4 ...
ACE_TOL = 5e-3
# ... except on a pair where two Gumbel keys tie to the last place (XLA's
# CPU log against torch's) and a moved row flips RANSAC's best hypothesis:
# one pair of nine read 0.48 px. At most one pair a run may, within 1 px.
FLIP_TOL = 1.0


# slow: each protocol runs JAX's tiny matcher on the CPU at its own batch
# shapes (~1 min a case under the tier-1 run's load); the serial chain stays
# in tier-1 through `test_benchmark_mace_matches_jax_per_pair`.
@pytest.mark.slow
@pytest.mark.parametrize("protocol", ["serial", "batched", "serial_keys_batched"])
def test_benchmark_protocols_match_jax_per_pair(trained, protocol):
    """`HomographyBenchmark.run` under JAX's key chains: serial against
    JAX's serial run, batched (2 a chunk, a ragged tail) against JAX's
    batched run, and batched with `serial_keys` against each pair solved
    under its serial key."""
    jm, tm, pairs, jax_pairs = trained
    batch_size, serial_keys = (None if protocol == "serial" else 2), protocol == "serial_keys_batched"
    bench = tbench.HomographyBenchmark(_Named("s", pairs))
    got = bench.run(tm, batch_size=batch_size, serial_keys=serial_keys)
    want, jax_mace = _jax_errors(jm, jax_pairs, batch_size, serial_keys)
    assert got["mace_s"] < 10.0  # the trained head registers these pairs
    diffs = np.abs(np.asarray(bench.errors) - np.asarray(want))
    assert (diffs > ACE_TOL).sum() <= 1 and diffs.max() <= FLIP_TOL, diffs
    if jax_mace is not None:
        assert abs(got["mace_s"] - jax_mace) <= FLIP_TOL / len(pairs)


def test_benchmark_mace_matches_jax_per_pair(trained):
    jm, tm, pairs, jax_pairs = trained
    _, want = jax_benchmark_mace(jm, jax_pairs, num_matches=2000)
    _, got = benchmark_mace(tm, pairs, num_matches=2000)
    diffs = np.abs(np.asarray(got) - np.asarray(want))
    assert (diffs > ACE_TOL).sum() <= 1 and diffs.max() <= FLIP_TOL, diffs
