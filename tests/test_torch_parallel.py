"""The multi-device path (`gfnet_tpu_torch/parallel/`) on the CPU: two gloo
ranks started by `torch_cpu.spawn_ranks` with a `file://` rendezvous,
at `tiny_test_config()` in float32, every package's weights from `seed=0`.

One spawn runs every two-rank case and saves what each rank saw; the tests
hold those readings against one process on the whole batch and against the
JAX package on a two-device mesh of the virtual CPU devices that
`tests/conftest.py` makes:
  - the train step on 2 × 4 pairs whose ranks count different supervision
    masks: loss, metrics, every gradient, the BatchNorm running statistics
    and the parameters after the step;
  - `corr_volume_flow_sharded` against the dense `corr_volume_flow` and
    JAX's sharded version;
  - serving under `shard_for_mesh`: B=3 (padded to 4, split by rows) and
    B=1 (latency mode, the coarse correlation split), against one process
    under the same key;
  - `cli.train.main([... "--multihost" ...])`: two steps, rank 0 writes the
    checkpoints, both ranks restore them;
  - the frozen ViT sharded over the ranks (`fsdp_vit`, at a `min_size` of
    1024): the split leaves against JAX's `fsdp_param_sharding`, the bytes a
    rank holds, the train step and serving against the unsharded ones.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from gfnet_tpu_torch.config import TrainConfig, tiny_test_config
from torch_cpu import one_thread, spawn_ranks  # noqa: F401

RES, BATCH = 112, 8
SPAWN_S = 150  # about three times the spawn's 47.5 s in the suite's six-worker run on 8 CPUs


# ------------------------------------------------------------- shared inputs
def train_inputs():
    """The global batch (8 uint8 pairs and their homographies): the last four
    pairs translated by 20-30 px, so rank 1 supervises far fewer cells than
    rank 0."""
    from gfnet_tpu_torch.eval.synthetic import train_batch

    batch = train_batch(np.random.default_rng(5), BATCH, RES, 0.15, uint8=True, device="cpu")
    H = batch["H_s2t"].clone()
    H[4:, :2, 2] += torch.tensor([[24.0, -20.0], [-30.0, 22.0], [26.0, 25.0], [-22.0, -28.0]])
    batch["H_s2t"] = H
    return batch


def serve_inputs():
    from gfnet_tpu_torch.eval.synthetic import eval_pairs

    pairs = eval_pairs(3, RES, 0.15, seed=77, device="cpu")
    a = torch.stack([p["im_A"] for p in pairs]).float() / 255.0
    b = torch.stack([p["im_B"] for p in pairs]).float() / 255.0
    return a, b


def corr_inputs():
    g = torch.Generator().manual_seed(3)
    return torch.randn((2, 8, 8, 16), generator=g), torch.randn((2, 8, 8, 16), generator=g)


SERVE_KEY = np.array([0, 42], np.uint32)
FSDP_MIN_SIZE = 1024


def step_head_vars() -> dict:
    """The train steps' head: seed 0's (`jax_head_params`, the JAX package's
    draw) with seeded noise on every leaf, as `tests/test_torch_train_step.py`
    jitters it, so that no BatchNorm, LayerScale or bias is an identity and
    the gradients are well conditioned; the same numpy tree feeds both
    packages."""
    from gfnet_tpu_torch.utils.jax_init import jax_head_params

    rng = np.random.default_rng(21)

    def go(t, name=""):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        if name == "var":
            return rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
        return (t + rng.normal(0, 0.05, t.shape)).astype(np.float32)

    return go(jax_head_params(tiny_test_config(), 0))


def step_matcher():
    """The tiny port matcher of the train steps: ViT from seed 0, the jittered head."""
    from gfnet_tpu_torch.matcher import GFNetMatcher
    from gfnet_tpu_torch.utils.convert import flax_to_torch_head

    return GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32, seed=0,
                        head_state=flax_to_torch_head(step_head_vars()))


def port_step(mesh, batch, m=None, **step_kw):
    """One train step of `m` (by default `step_matcher()`), clip out of
    reach (so `.grad` keeps the raw combined gradients), `step_kw` to
    `make_train_step`: (metrics, grads, running statistics, parameters
    after the step)."""
    from gfnet_tpu_torch.train.loss import RobustLoss
    from gfnet_tpu_torch.train.state import create_train_state
    from gfnet_tpu_torch.train.step import make_train_step

    m = m or step_matcher()
    state = create_train_state(m.head, TrainConfig(grad_clip_norm=1e30), BATCH)
    state, metrics = make_train_step(m, RobustLoss(im_size=RES), mesh, **step_kw)(state, batch)
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.clone() for k, p in m.head.named_parameters()},
            {k: v.clone() for k, v in m.head.named_buffers()},
            {k: p.detach().clone() for k, p in m.head.named_parameters()})


# ----------------------------------------------------------- the two ranks
def _ranks(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    """Every two-rank case on this rank; results to `out_dir/rank{r}.pt`."""
    os.environ["GFNET_GRAD_BREAKDOWN"] = "1"
    import gfnet_tpu_torch.models.gfnet as gfnet_module
    from gfnet_tpu_torch.cli import train as cli_train
    from gfnet_tpu_torch.matcher import GFNetMatcher
    from gfnet_tpu_torch.ops.correlation import corr_volume_flow_sharded
    from gfnet_tpu_torch.parallel import init_distributed, shard_batch, shard_params
    from gfnet_tpu_torch.train.checkpoint import Checkpointer
    from gfnet_tpu_torch.train.state import create_train_state

    mesh = init_distributed("cpu", init_method=rendezvous, world_size=world, rank=rank)
    out = {"mesh": (mesh.size, mesh.rank)}
    batch = train_inputs()
    local = shard_batch(mesh, batch)
    out["local_H"] = local["H_s2t"]
    out["step"] = port_step(mesh, local)
    # the same step with the ViT sharded: at 2^16 nothing of the tiny ViT is
    # split, so at 1024 (its weights, patch and position embeddings)
    fm = step_matcher()
    full = {k: p.numel() * p.element_size() for k, p in fm.vit.named_parameters()}
    out["step_fsdp"] = port_step(mesh, local, fm, fsdp_vit=True, fsdp_min_size=FSDP_MIN_SIZE)
    held = {k: p.numel() * p.element_size() for k, p in fm.vit.named_parameters()}
    out["fsdp"] = {"spec": fm.vit.fsdp.spec, "full_bytes": full, "held_bytes": held,
                   "gathers_per_step": fm.vit.fsdp.gathers}
    try:
        fm.vit.state_dict()
        out["fsdp"]["state_dict"] = "handed out"
    except RuntimeError as e:
        out["fsdp"]["state_dict"] = str(e)

    f0, f1 = corr_inputs()
    out["corr"] = corr_volume_flow_sharded(f0, f1, mesh)

    a, b = serve_inputs()
    m = GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32, seed=0)
    m.shard_for_mesh(mesh)
    out["serve_b3"] = m.estimate_homography_batched(a, b, 300, key=SERVE_KEY)
    out["match_b3"] = m.match(a, b)
    fm = GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32, seed=0)
    shard_params(mesh, fm.vit, FSDP_MIN_SIZE)
    fm.shard_for_mesh(mesh, fsdp_vit=True)  # keeps the ViT sharded at 1024
    out["serve_b3_fsdp"] = fm.estimate_homography_batched(a, b, 300, key=SERVE_KEY)
    calls = []
    real = gfnet_module.corr_volume_flow_sharded
    gfnet_module.corr_volume_flow_sharded = lambda *args: calls.append(1) or real(*args)
    try:
        lat = GFNetMatcher(tiny_test_config().replace(symmetric=False), device="cpu",
                           dtype=torch.float32, seed=0)
        lat.shard_for_mesh(mesh)
        out["serve_b1"] = lat.estimate_homography(a[1], b[1], 300, key=SERVE_KEY)
    finally:
        gfnet_module.corr_volume_flow_sharded = real
    out["latency_sharded_corr_calls"] = len(calls)

    workspace = os.path.join(out_dir, "ws")
    rows = BATCH // 2 // world
    steps = [{k: v[i * 4:(i + 1) * 4][mesh.rows(4)] for k, v in batch.items()} for i in range(2)]
    state = cli_train.main(["--dataset", "synth", "--tiny", "--device", "cpu", "--multihost",
                            "--workspace", workspace, "--gpu_batch_size", str(rows),
                            "--total_pairs", "8", "--ckpt_every", "4", "--log_every", "1"],
                           batches=iter(steps))
    mesh.barrier()
    fresh = GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32, seed=1)
    restored = Checkpointer(workspace, "synth", mesh=mesh).restore(
        create_train_state(fresh.head, TrainConfig(), BATCH // 2))
    out["cli"] = {"step": state.step, "head": {k: v.clone() for k, v in state.head.state_dict().items()},
                  "restored_step": restored.step, "restored": restored.head.state_dict(),
                  "files": sorted(os.listdir(os.path.join(workspace, "synth")))}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.barrier()
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    rendezvous = f"file://{out / 'rendezvous'}"
    spawn_ranks(_ranks, (2, rendezvous, str(out)), nprocs=2, seconds=SPAWN_S)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def one_process():
    """The train step of one process on the whole batch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GFNET_GRAD_BREAKDOWN", "1")
        return port_step(None, train_inputs())


# ------------------------------------------------------------------- tests
def test_ranks_formed_a_mesh_of_two(two_ranks):
    assert [r["mesh"] for r in two_ranks] == [(2, 0), (2, 1)]


def _supervised_cells(H):
    from gfnet_tpu_torch.train.loss import gt_warp_from_homography

    _, prob = gt_warp_from_homography(H, (RES, RES), (RES, RES), (8, 8))
    return int((prob > 0.99).sum())


def _is_loss(name: str) -> bool:
    return "loss" in name or "pck" in name


# The step's losses gate their supervision on thresholds (the previous
# scale's error, gt prob > 0.99), so float32 rounding that moves a cell
# across one moves a few cells' terms, and the gradients of the refiners fed
# by them: one process on this batch against itself with its rows permuted
# reads 7.0e-4 relative on a module's gradient norm (merge_layer), 9.8e-3 of
# a module's largest entry on a leaf (refiners_8's block1) and 2.0e-4 on a
# parameter after the step (an Adam update flips with a near-zero
# gradient's sign: 2 × lr). The tolerances below sit above those.
NORM_RTOL, LOSS_RTOL, LEAF_TOL, STATS_TOL, PARAM_ATOL = 2e-3, 1e-5, 2e-2, 1e-5, 3e-4


def test_train_step_on_two_ranks_equals_one_process(two_ranks, one_process):
    """2 × 4 pairs against 8 pairs in one process. The ranks' supervision
    masks count differently, so a per-rank masked mean averaged over the
    ranks would read another loss. A sound run read: losses and pck to
    4e-7, gradient norms 6.3e-4, a leaf 9.8e-3 of its module's largest
    entry, running statistics 1.2e-7, parameters after the step 2.0e-4,
    i.e. what a row permutation of one process reads (tolerances above);
    both ranks hold the same parameters bit for bit."""
    counts = [_supervised_cells(r["local_H"]) for r in two_ranks]
    assert counts[0] > counts[1] + 50 > 50, counts  # a sound run: 236 and 155
    metrics, grads, stats, params = one_process
    top = lambda k: ".".join(k.split(".")[:2 if k.startswith("conv_refiner") else 1])
    scale: dict = {}
    for k, g in grads.items():
        scale[top(k)] = max(scale.get(top(k), 0.0), float(g.abs().max()))
    for r in two_ranks:
        got_m, got_g, got_s, got_p = r["step"]
        assert sorted(got_m) == sorted(metrics)
        for k, v in metrics.items():
            assert got_m[k] == pytest.approx(v, rel=LOSS_RTOL if _is_loss(k) else NORM_RTOL, abs=1e-7), k
        for k, g in grads.items():
            assert float((got_g[k] - g).abs().max()) <= LEAF_TOL * scale[top(k)], k
        for k, v in stats.items():
            torch.testing.assert_close(got_s[k], v, rtol=STATS_TOL, atol=STATS_TOL, msg=k)
        for k, v in params.items():
            torch.testing.assert_close(got_p[k], v, rtol=0, atol=PARAM_ATOL, msg=k)
    for k in params:
        assert torch.equal(two_ranks[0]["step"][3][k], two_ranks[1]["step"][3][k]), k


# slow: JAX compiles its two-device train step (~70 s alone on the CPU); in
# tier-1 the two ranks are held to one process (above), and one process to
# JAX's step in `tests/test_torch_train_step.py`.
@pytest.mark.slow
def test_train_step_on_two_ranks_matches_jax_on_a_mesh_of_two(two_ranks, monkeypatch):
    """JAX's `make_train_step(matcher, loss, create_mesh(2))` on the same
    global batch and weights (ViT from seed 0, the jittered head): its
    metrics and running statistics. Losses and pck to 1e-5 relative and the
    statistics to `tests/test_torch_train_step.py`'s 1e-4 + 1e-5; the
    gradient norms to 2e-3, not that file's 5e-4: on these 8 pairs a row
    permutation moves one process's by 7e-4 (above), and JAX's own mesh
    step reads 3e-4 from its one-device step. A sound run read 8.1e-4
    (encoder)."""
    import jax
    import jax.numpy as jnp

    from gfnet_tpu.config import TrainConfig as JTrainConfig
    from gfnet_tpu.config import tiny_test_config as jax_tiny_config
    from gfnet_tpu.matcher.api import GFNetMatcher as JGFNetMatcher
    from gfnet_tpu.parallel.mesh import create_mesh, shard_batch
    from gfnet_tpu.train.loss import RobustLoss as JRobustLoss
    from gfnet_tpu.train.state import create_train_state as j_create_train_state
    from gfnet_tpu.train.step import make_train_step as j_make_train_step
    from gfnet_tpu_torch.utils.convert import flax_to_torch_head

    monkeypatch.setenv("GFNET_S2D", "0")
    monkeypatch.setenv("GFNET_GRAD_BREAKDOWN", "1")
    monkeypatch.delenv("GFNET_KV_NORM", raising=False)
    jm = JGFNetMatcher(jax_tiny_config(), seed=0, dtype=jnp.float32)
    mesh = create_mesh(2)
    batch = {k: v.numpy() for k, v in train_inputs().items()}
    state = j_create_train_state(jax.tree_util.tree_map(jnp.asarray, step_head_vars()),
                                 JTrainConfig(grad_clip_norm=1e30), BATCH)
    step = j_make_train_step(jm, JRobustLoss(im_size=RES), mesh)
    new_state, metrics = step(state, jm.vit_params, shard_batch(mesh, batch))
    want = {k: float(v) for k, v in metrics.items()}
    got = two_ranks[0]["step"][0]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=LOSS_RTOL if _is_loss(k) else NORM_RTOL, atol=1e-6, err_msg=k)
    want_stats = flax_to_torch_head({"params": jax.tree_util.tree_map(np.asarray, new_state.params),
                                     "batch_stats": jax.tree_util.tree_map(np.asarray, new_state.batch_stats)})
    for k, v in two_ranks[0]["step"][2].items():
        np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_sharded_correlation_equals_dense_and_jax(two_ranks):
    """Each rank scores half the target cells; the combined expectation is
    the dense one's to float32 rounding (2e-6) on both ranks, and JAX's
    `corr_volume_flow_sharded` on a mesh of two."""
    import jax.numpy as jnp

    from gfnet_tpu.ops.correlation import corr_volume_flow_sharded as jax_sharded
    from gfnet_tpu.parallel.mesh import create_mesh
    from gfnet_tpu_torch.ops.correlation import corr_volume_flow

    f0, f1 = corr_inputs()
    dense = corr_volume_flow(f0, f1)
    want = np.asarray(jax_sharded(jnp.asarray(f0.numpy()), jnp.asarray(f1.numpy()), create_mesh(2)))
    for r in two_ranks:
        torch.testing.assert_close(r["corr"], dense, rtol=0, atol=2e-6)
        np.testing.assert_allclose(r["corr"].numpy(), want, rtol=0, atol=2e-6)


def test_sharded_serving_equals_one_process(two_ranks):
    """B=3 on two ranks (padded to 4; rank 0 rows 0-1, rank 1 row 2 and its
    repeat) and B=1 in latency mode (the whole pair on both ranks, the
    coarse correlation split), against one process under the same key: each
    pair draws from `split(key, B)[i]` either way. H within 1e-3 px of
    corner error (the pass runs at another batch size; sound runs read
    below 1e-4); `match` returns the whole batch on every rank."""
    from gfnet_tpu_torch.core.homography import corner_error
    from gfnet_tpu_torch.matcher import GFNetMatcher

    a, b = serve_inputs()
    m = GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32, seed=0)
    H3 = m.estimate_homography_batched(a, b, 300, key=SERVE_KEY)
    warp, cert = m.match(a, b)
    lat = GFNetMatcher(tiny_test_config().replace(symmetric=False), device="cpu", dtype=torch.float32, seed=0)
    H1 = lat.estimate_homography(a[1], b[1], 300, key=SERVE_KEY)
    for r in two_ranks:
        assert r["serve_b3"].shape == (3, 3, 3)
        for i in range(3):
            assert float(corner_error(r["serve_b3"][i], H3[i], RES, RES)) < 1e-3, i
        torch.testing.assert_close(r["match_b3"][0], warp, rtol=0, atol=1e-5)
        torch.testing.assert_close(r["match_b3"][1], cert, rtol=0, atol=1e-5)
        assert r["latency_sharded_corr_calls"] == 1  # pass 1's coarse init, B' = 1 on two ranks
        assert float(corner_error(r["serve_b1"], H1, RES, RES)) < 1e-3


def test_multihost_cli_trains_checkpoints_on_rank0_and_both_restore(two_ranks):
    """Two steps of 2 × 2 pairs through `cli.train.main(--multihost)`: a
    checkpoint a step, written once (no temporary files left), and both
    ranks restore the last one equal to the state they trained."""
    r0, r1 = (r["cli"] for r in two_ranks)
    assert r0["step"] == r1["step"] == 2
    assert r0["files"] == r1["files"] == ["step_000000001.pt", "step_000000002.pt"]
    for r in (r0, r1):
        assert r["restored_step"] == 2
        for k, v in r["head"].items():
            assert torch.equal(r["restored"][k], v), k
    for k, v in r0["head"].items():
        assert torch.equal(r1["head"][k], v), k


# ---------------------------------------------------------------- FSDP ViT
def _jax_fsdp_split(mesh_size: int, min_size: int) -> dict:
    """Torch name → whether JAX's `fsdp_param_sharding` splits the tiny
    ViT's leaf on a mesh of `mesh_size`, over the parameter shapes of
    `jax.eval_shape` (nothing is compiled), carried to the port's names by
    the weight bridge on 0/1 arrays; and JAX's bytes a rank holds."""
    import jax
    import jax.numpy as jnp

    from gfnet_tpu.config import tiny_test_config as jax_tiny_config
    from gfnet_tpu.models.vit import VisionTransformer as JViT
    from gfnet_tpu.parallel.mesh import create_mesh, fsdp_param_sharding
    from gfnet_tpu_torch.utils.convert import flax_to_torch_vit

    vit = JViT(jax_tiny_config().dino, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: vit.init(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3))))["params"]
    spec = fsdp_param_sharding(create_mesh(mesh_size), shapes, min_size=min_size)
    split = jax.tree_util.tree_map(lambda sh: any(a is not None for a in sh.spec), spec)
    flags = jax.tree_util.tree_map(lambda s, x: np.full(x.shape, float(s), np.float32), split, shapes)
    per_rank = sum(x.size * x.dtype.itemsize // (mesh_size if s else 1) for s, x in
                   zip(jax.tree_util.tree_leaves(split), jax.tree_util.tree_leaves(shapes)))
    named = {k: bool(v.flatten()[0]) for k, v in flax_to_torch_vit(flags).items()}
    return named, per_rank


def test_fsdp_splits_the_leaves_jax_splits_and_a_rank_holds_its_share(two_ranks):
    """The port's `fsdp_param_sharding` on the tiny ViT splits the leaves
    JAX's splits on a two-device mesh (the weights, patch and position
    embeddings; biases, norms and LayerScales stay whole), and after a
    sharded step each rank holds half of each split leaf, exactly JAX's
    bytes a rank. A sharded ViT refuses `state_dict()`."""
    want, jax_per_rank = _jax_fsdp_split(2, FSDP_MIN_SIZE)
    for r in two_ranks:
        f = r["fsdp"]
        assert {k: v is not None for k, v in f["spec"].items()} == want
        split = [k for k, v in want.items() if v]
        assert len(split) == 10, split  # 4 weights in each of 2 blocks, the patch and position embeddings
        held = sum(f["held_bytes"][k] for k in split) / sum(f["full_bytes"][k] for k in split)
        assert held <= 0.55, held
        assert sum(f["held_bytes"].values()) == jax_per_rank
        assert f["gathers_per_step"] == 4  # the ViT, its patch embedding and 2 blocks, once each
        assert "split over the ranks" in f["state_dict"]


def test_fsdp_step_and_serving_equal_the_unsharded_ones(two_ranks):
    """The all-gathers rebuild the same weights: the two-rank step with
    `fsdp_vit=True` equals the one without bit for bit (metrics, gradients,
    running statistics, parameters after the step), and serving with a
    sharded ViT gives the same H bit for bit."""
    for r in two_ranks:
        for got, want in zip(r["step_fsdp"], r["step"]):
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                assert (got[k] == v) if isinstance(v, float) else torch.equal(got[k], v), k
        assert torch.equal(r["serve_b3_fsdp"], r["serve_b3"])
