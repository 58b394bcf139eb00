#!/usr/bin/env python3
"""Drive the PyTorch port (`gfnet_tpu_torch`) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device: the card's name and power limit (`nvidia-smi`), TF32 switched off
     for float32 matmuls and convolutions;
  2. build: compile the CUDA kernels from `gfnet_tpu_torch/csrc/`;
  3. K1 (oneshot_attention) against its plain version at every main-path
     attention shape, bf16, with timings (kernel, plain, SDPA), then on slices
     of a fused qkv projection as the ViT hands them over, against the plain
     version that repeats the kernels' schedule, then the main-path shapes in
     float32 (three TF32 passes, held to their own gate), then at the head
     dims a config can give (32, 128, 256, 12 zero-padded to 16, and above
     256, where bf16 runs the wide kernel and float32 column groups: 320, 384,
     512) and the ViT at 1120² (kv 6401), each in bf16 and float32, then in
     bf16 D = 128 and 320 at B = 16 (no kv split) and D = 300 on ragged q and
     kv (each row names its kernel; every bf16 row above 256 also against
     the plain version that sums the logits box by box, as the kernel does),
     and the host's cost of one launch;
  4. K2 (local_corr) against its plain version at every main-path shape, on
     a homography flow (the refiners' smooth flow: tiles stage their windows
     in shared memory) and a random one (the worst case: no tile stages),
     each with the share of staged tiles and the target bytes either way,
     and on the homography flow also with staging off (a box of one window);
     then a flow where every tile stages and one that mixes both branches
     (also against the plain version of the kernel's schedule), exact zeros
     for far-out-of-range and NaN flow, the host's cost of a launch, and K2
     and K3 at C = 12 in bf16 (zero-padded to 16 by `local_correlation`);
  5. the tiny config's `match()` on CUDA (kernels) against the CPU (plain
     versions), float32, same weights (seeded ViT, trained tiny head) and
     images;
  6. the main path: `GFNetMatcher.from_pretrained` at the flagship
     `ModelConfig()` width in bf16 (the JAX package's seed-0 random ViT-L,
     drawn bit for bit by `utils/jax_init.py`, with its draw time; the
     trained head `workspace/trained_head_flagship_r5b.npz`),
     `estimate_homography` on one
     448² pair and `estimate_homography_batched` on 8, with launch counts,
     throughput and peak memory; then, for B=1 and B=8, each phase (pass 1,
     pass 2, sample + solve) timed alone and profiled once for its device
     time, busy share and top kernels, and how K2 tiles the refiners' own
     flows (share of staged tiles per launch);
  k4: K4 (kde, the sampler's density) on the flagship's own sampled
     candidates (8 pairs and 1 pair, 20,000 each) against the plain path:
     bit for bit (K4 sums in the order of the plain path's reduction; the
     largest relative difference beside it), two runs bit for bit,
     the share of cuBLAS's float32 dots (the plain path's) that the kernel's
     FMA chain repeats bit for bit, the candidates that cross the sampler's
     `density < 10` cut, and K4's ms beside the plain path's and its bound;
  k5: K5 (residual_norm, the ViT block's residual stream) at the rows of a
     batch call's 560² pass, ViT-L (16·1601 × 1024) and ViT-g-reg (16·1605 ×
     1536), bf16, in each of its three uses (norm alone, add and norm, add
     alone) against the plain path: s bit for bit, n within one bf16 ulp
     (plus float32 rounding of the norm's terms where they cancel) and off
     on under 1% of elements; K5's ms beside the plain path's and its
     bound (bytes over 3.35 TB/s);
  k6: K6 (refine_block, the refine block's depthwise 5x5 conv, BatchNorm and
     ReLU) at the nine (B', G, C) of a basic batch call's refiners (B' = 16;
     pass 1 G 32/32/64/128/256, C 417/361/177/73/24; pass 2 G 40/80/160/320)
     against the plain chain (`k6_error`: at most 1% of elements off, each
     within |mul|·(ulp(s) + 2^-16 of the taps' terms) + ulp(out); NaN and inf
     where the plain path has them), two runs bit for bit; K6's ms beside the
     plain chain's and its bound (4 bytes an element over 3.35 TB/s), and
     the total of a call (nine blocks a refiner call); untimed, the same
     gates at the nine shapes of a single pair's call (B' = 2, the serve
     cell's and the flagship's tiles), and in float32 (the float32 model's
     path: within |mul|·2^-16 of the taps' terms plus float32 rounding of
     the BatchNorm's terms) at B' = 2;
  flagship_f32: the flagship in float32 (the JAX package's
     `GFNetMatcher(cfg, dtype=jnp.float32)`), B = 1, one pair, TF32 off:
     `match()` on the card against the same weights on the CPU, and each
     pass's ms and K1 launches beside the bf16 matcher's;
  accuracy: the evaluation path on that matcher: `eval_pairs(100, 448, 0.3,
     seed=1234)` same-modal and cross-modal, made on the card, through
     `HomographyBenchmark` at batch 4 with each pair under its key of the
     JAX package's serial chain from `PRNGKey(0)` (`serial_keys`), with the
     launch counts of the run. Gate: each pair's ACE against the JAX
     package's float32 reading of the first 16 pairs of each set
     (`gfnet_tpu_torch/eval/jax_accuracy_r5b.json`, made by
     `scripts/read_jax_accuracy.py` under that chain: the same draws; the
     mean |ΔACE| over the pairs JAX registers below 1 px), and each set's
     100-pair MACE against the TPU oracle `workspace/eval_synth_r5b.json`;
  data: the dataset path of both CLIs on the card, files read without PIL:
     (a) the committed JPEG/PNG fixtures (`tests/data/images`) decoded by
     the image library built here against PIL's stored decode, and the
     decode ms of a 640×480 4:2:0 JPEG on one thread and in a pool; (b)
     `tools/make_synth_valdir` writes 16 pairs at 448² on the card,
     `cli.test.main` evaluates them at full width (bf16, the r5b head),
     the flagship matcher evaluates the same `eval_pairs` in memory under
     the same keys: the MACEs within DATA_MACE_TOL, and a planted fault
     (source channels reversed) far outside; (c) `cli.train.main` at full
     width over a googlemap-layout directory (B=8, 64 pairs, decode
     threads, augmentations and pair synthesis on the card): finite losses,
     step ms, the loader's ms per batch alone and in the loop, the card's
     busy share over the steady steps;
  orbax: the JAX package's Orbax checkpoints in the port (read without
     orbax: `utils/orbax.py`, zstd in `csrc/zstd.cpp` built here): (a) every
     leaf of the JAX trainer's step directory `tests/data/orbax/tiny_run`
     equal to its `.npz`, and the Orbax flagship head equal to
     `load_head_npz(r5b)`, bit for bit, with the head's read rate; (b)
     `cli.test --ckpt_path <Orbax head>` at full width over the data phase's
     val directory with `decoder.kv_norm: true` in the config: the MACE of
     the data phase's `.npz` run within DATA_MACE_TOL, and without k/v
     standardization (the planted fault) far outside; (c) `cli.train --ft
     --ft_ckpt <Orbax head>` at full width over the data phase's googlemap
     directory: the first loss within ORBAX_LOSS_RTOL of the `.npz` start's;
     (d) the port's `Checkpointer` resumes JAX's step 2 on the card, the
     third fed update against JAX's stored parameters (ORBAX_RESUME_ATOL;
     the AdamW count one ahead far outside), then `cli.train --tiny`
     auto-resumes the run and writes a later `step_<N>.pt`;
  learn: the port learns on the card: `eval/learnability.run` (the tiny
     config from the JAX package's seed-0 draw, 500 steps of 8 synthetic
     pairs made on the card, then `benchmark_mace` on 16 held-out pairs);
     gate: random weights at least 40 px, trained at most 10 px;
  7. K3 (local_corr_bwd) against its plain version at the four shapes the
     train step gives it (B=8, float32) and with a bf16 target, plus K2 at
     those float32 shapes, on the same flows as phase 4, with two K3 launches
     that must agree bit for bit, exact zeros for out-of-range and NaN flow,
     and the host's cost of a K3 launch;
  8. one train step of the tiny config on CUDA (kernels) against the CPU
     (plain versions), float32: the loss and every head gradient;
  9. the trainer at the flagship width: a few steps of `cli.train.train_loop`
     at B=8, 448², bf16, on a synthetic homography stream made on the card,
     with checkpoints, a restore that compares equal, the launch counts per
     step, step time, peak memory, one profiled step, and how K2 and K3 tile
     the refiners' flows of one more step;
  ops_extra: the ops off the main path that reach the card:
     `local_correlation_multilevel` (K2 at each of 3 pooled levels) against
     the plain version, and `grid_sample` with border padding against the CPU;
  dist: the multi-device path over NCCL in a world of one (the card's
     machine has one GPU; more ranks are held on the CPU by
     `tests/test_torch_parallel.py`): the flagship train step (B=8, 448²,
     bf16) through `make_train_step(mesh=...)`, with the ViT whole and
     sharded (`fsdp_vit=True`), against the same step without a mesh (loss
     and every gradient, phase 8's gates), one step with and one without the
     mesh profiled (`utils/profiling.trace`), `shard_for_mesh` serving at B=8
     with the ViT whole and sharded against the unsharded matcher under one
     key (equal H), the ViT's resident bytes and all-gathers, and
     `corr_volume_flow_sharded` against the dense version.
Then the seconds each phase took, a line with the per-kernel summary (K2
and K3 at their slowest shape on the homography flow, the random flow's time
beside it), and as the last line `{"ok": true, "device": {...}}`. Any failed check exits non-zero without it.
Exits non-zero without a result when CUDA is unavailable or the package is
not beside this script.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HEAD_NPZ = ROOT / "workspace" / "trained_head_flagship_r5b.npz"
TINY_HEAD = ROOT / "workspace" / "trained_head_tiny.npz"
JAX_ACCURACY = ROOT / "gfnet_tpu_torch" / "eval" / "jax_accuracy_r5b.json"
ORACLE = ROOT / "workspace" / "eval_synth_r5b.json"
FIXTURES = ROOT / "tests" / "data" / "images"  # scripts/make_image_fixtures_torch.py
LOG = ROOT / "chiprun_out" / "chip_smoke.jsonl"
# the oracle's protocol: 100 pairs a set at 448², deformation 0.3, batches of 4
ACC_PAIRS, ACC_RES, ACC_DEFORMATION, ACC_SEED, ACC_BATCH = 100, 448, 0.3, 1234, 4

# The card's peaks and `bound()` are `gfnet_tpu_torch/utils/profiling.py`'s.
# exponentials: 16 a clock on each of the 132 SMs' special-function units, at
# the card's maximum SM clock as `nvidia-smi` reports it (phase 1)
SFU_PER_CLOCK = 16 * 132
SPIN_CYCLES = 10_000_000  # ~5 ms: the card spins while the host queues the calls to be timed

# Tolerances, each above the largest error of sound runs and below what a
# small planted fault reads (readings: chip_smoke.py and
# scripts/plant_faults_torch.py on an H100 80GB HBM3 at 700 W).
# K1: bf16 output and PV-operand rounding against a float32 plain version.
# Sound runs read at most 1.97e-3 (at (16,1024,8,8)); the softmax scale off by
# 1% reads 1.27e-2 at (2,1601,16,64) and 3.4e-2 at (2,1600,8,8), the last 64
# keys dropped 0.22 and 0.27, a V tile taken one ring stage late 0.59 and 0.99.
K1_ATOL = 3e-3
# K1 in float32 (three TF32 passes) against the float32 plain version: the
# order of float32 sums and ~2^-22 of each product. Sound runs read at most
# 1.97e-6 (at (2,1600,8,8)); a single TF32 pass (q, k, v rounded to TF32
# first: `scripts/plant_faults_torch.py k1`) reads 1.28e-4 (kv 6401) to
# 8.89e-4 (D=8).
K1_F32_ATOL = 2e-5
# K1 against the plain version that repeats its schedule, both bf16: the two
# differ by the order of float32 sums and the last bit of `ex2`, so mostly by
# one rounding of the bf16 output (2^-8 relative). Sound runs read at most 2.4e-3.
K1_STREAMED_RTOL = 2 ** -7
# K2: the same bf16 inputs on both sides and float32 accumulation, so only
# the summation order differs. Sound runs read at most 9.5e-7; one tap of
# each window zeroed reads 2.76 and more.
K2_ATOL = 1e-4
# Tiny config end to end, float32, TF32 off: summation order on the card vs
# the CPU, amplified by the trained refiners (the warp reads 3.84e-4 in sound
# runs, the certainty 1.4e-8). K1's scale off by 1% reads 0.245 and one K2
# tap zeroed 0.756. With a seeded random head the refiners add ~1e-6, and a
# zeroed K2 tap read the same as a sound run, so the trained head is used.
E2E_ATOL = 1e-3
# K3: float32 sums of up to (2r+2)²·C products, in another order than the
# plain version's einsum. Sound runs read at most 4.3e-6; the 1/√C scale off
# by 1% reads 0.061 and more, the centre tap of the gradient dropped 1.05.
K3_ATOL = 1e-4
# the kernels a train step launches (K4 samples matches, which training never does)
TRAIN_KERNELS = ("oneshot_attention", "local_corr", "local_corr_bwd")
# One train step of the tiny config, float32, TF32 off, CUDA against CPU:
# the loss relative to the CPU's (sound runs read 7.1e-8), and each leaf's
# gradient relative to the largest gradient entry of its top-level module on
# the CPU. Sound runs read 3.7e-3 (the refiners amplify summation order, as
# in the forward gate); K3's scale off by 1% reads 1.13e-2, the centre tap of
# its incoming gradient dropped 0.53.
TINY_LOSS_RTOL = 1e-4
TINY_GRAD_RTOL = 8e-3
# Accuracy at the flagship width (bf16 on the card against the JAX package in
# float32 on the same uint8 pairs, and against the TPU oracle): the sampling
# draws differ, so a pair's ACE moves by sampling noise, and a set's MACE by
# that noise and by the few pairs far off. ACC_PAIR_TOL: the mean of
# |ACE port - ACE JAX| over the compared pairs that JAX registers below
# ACC_REGISTERED px (27 of the 32), px. Sound runs read 0.043-0.060 over four
# sampling seeds; K2's centre tap zeroed reads 0.092, the backbone drawn before
# the JAX draw 15.8; K1's scale off by 1% reads 0.052 and is not caught.
# Under the JAX package's keys both sides now draw alike; what the gate reads
# then is in PERF.md §2.
# ACC_MACE_TOL: |100-pair MACE - oracle MACE| per set, px: sound runs read
# 1.79-2.58 below the oracle (it ran on a TPU, on cv2's pairs), the backbone
# drawn before the JAX draw 13.3 and 17.1 above; neither kernel fault moves it.
ACC_REGISTERED = 1.0
ACC_PAIR_TOL = 0.075
ACC_MACE_TOL = {"synthetic": 5.0, "synthetic_crossmodal": 5.0}
# the sound readings of the mean |ΔACE| when the port drew from a torch
# generator (PERF.md §2), printed beside this run's
ACC_PAIR_TORCH_DRAWS = (0.043, 0.060)
# Learnability (tests/test_learnability.py's gate on random weights; a
# trained bound far above the JAX script's 2.96 px, which is a finding to
# chase, not a reason to loosen it). JAX's CPU readings: 67.42 / 2.96 px.
LEARN_RANDOM_MIN, LEARN_TRAINED_MAX = 40.0, 10.0
# The sharded correlation against the dense one in a world of one: the same
# float32 sums, so rounding only (the softmax's max is taken apart).
DIST_CORR_ATOL = 1e-5
# Sharded serving in a world of one runs the unsharded computation on the
# same rows and keys, then an NCCL all-gather: equal H, up to the card's
# run-to-run rounding (corner error, px).
DIST_SERVE_PX = 1e-3
# flagship train steps timed with and without the mesh, in turns (a reading)
DIST_STEP_REPEATS = 5
# `grid_sample` with border padding, float32, on the card against the CPU:
# both are `F.grid_sample`, whose corner weights round alike up to the
# order of a few float32 operations on values of about 1
GRID_SAMPLE_ATOL = 1e-5
# The data phase: `cli.test` over a PNG val directory of DATA_PAIRS pairs
# against the flagship matcher on the same pairs in memory under the same
# keys: PNG is lossless and the val resize at the same size a copy, so the
# two read the same pixels; px.
DATA_PAIRS, DATA_MACE_TOL = 16, 1e-3
# `cli.train` over a googlemap layout: DATA_TRAIN_PAIRS image pairs of
# (h, w) DATA_TRAIN_HW (the bottom crop leaves 540 rows, which
# ResizeShorter(640) then enlarges), DATA_TRAIN_PAIRS_RUN pairs trained,
# decode threads, the fetch from which the profile runs (the steps before
# it, the first aside, give the medians: the profiler slows the host),
# batches timed alone.
DATA_TRAIN_PAIRS, DATA_TRAIN_HW, DATA_TRAIN_PAIRS_RUN = 32, (640, 740), 64
DATA_WORKERS, DATA_PROFILE_FROM, DATA_LOADER_BATCHES = 8, 6, 6
# The orbax phase: the JAX package's Orbax checkpoints read by the port
# (`utils/orbax.py`, `scripts/make_orbax_fixtures_torch.py`'s fixtures).
# (b) and (c) hold the Orbax head to the data phase's `.npz` runs: the same
# weights bit for bit, so the data phase's MACE gate and the dist phase's
# relative loss gate; the same runs without the config's k/v standardization
# must read outside each gate by ORBAX_KV_FAULT_FACTOR. (d) holds the
# third fed AdamW update after the port resumed JAX's step 2 to JAX's stored
# parameters: float32 AdamW against optax differ by rounding (max |Δ| 1.2e-7
# read on the CPU); the planted fault, the AdamW count one step ahead, moves
# the bias correction by ~25% (9.1e-6 on the CPU): the gate lies between.
ORBAX_FIXTURES = ROOT / "tests" / "data" / "orbax"
ORBAX_KV_FAULT_FACTOR = 10
ORBAX_LOSS_RTOL = 1e-4
ORBAX_RESUME_ATOL = 1e-6
ORBAX_FT_STEPS = 2
LEARN_JAX = {"mace_random": 67.42307868745905, "mace_trained": 2.9560503634743203,
             "source": "workspace/learnability_500.json (scripts/learnability_e2e.py, CPU)"}


def emit(phase: str, **kw) -> None:
    line = json.dumps({"phase": phase, **kw})
    print(line, flush=True)
    LOG.parent.mkdir(exist_ok=True)
    with open(LOG, "a") as f:  # every line, where the end of the output holds only the last ones
        f.write(line + "\n")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call, by CUDA events around `iters` calls that were
    queued while the card was busy with a spin kernel: a call that the host
    takes longer to launch than the card to run is then not timed at the
    host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"nvidia_smi": smi, "max_sm_mhz": max_sm_mhz,
            "exp_per_s": SFU_PER_CLOCK * max_sm_mhz * 1e6, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    emit("device", **info)
    return info


def phase_build() -> None:
    from gfnet_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.load_library()
    # registers, spills, and the compiler's advisories (a serialised wgmma
    # pipeline is reported as "Potential Performance Loss")
    report = [ln.strip() for ln in kernels.build_info["log"].splitlines()
              if "registers" in ln or "Compiling entry" in ln or "spill" in ln or "Performance" in ln]
    emit("build", seconds=time.perf_counter() - t0, built=kernels.build_info["built"],
         ptxas=report)


def phase_k1(torch, exp_rate: float) -> dict:
    import torch.nn.functional as F

    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.ops.attention import (entropy_invariant_scale, scaled_dot_product_attention,
                                               streamed_attention_plain)
    from gfnet_tpu_torch.utils.profiling import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_TF32_FLOPS, bound, counters

    gen = torch.Generator("cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    # (B, N, H, D, scale) as the main path calls K1: the ViT at 448²/560² on
    # the stacked pair, the cross-view decoder with both directions stacked;
    # then the train step's two shapes (8 pairs at 448²)
    shapes = [(2, 1025, 16, 64, 64**-0.5), (2, 1601, 16, 64, 64**-0.5),
              (2, 1024, 8, 8, entropy_invariant_scale(8, 1024, 1024)),
              (2, 1600, 8, 8, entropy_invariant_scale(8, 1600, 1024)),
              (16, 1025, 16, 64, 64**-0.5),
              (16, 1024, 8, 8, entropy_invariant_scale(8, 1024, 1024))]
    # head dims a config can give the cross-view decoder (nhead 2 over 64
    # channels: D=32; nhead 1 over 128, 256, 320, 384, 512: D=128 to 512, the
    # last three on the wide kernel in bf16 and in column groups in float32;
    # D=12, zero-padded to 16), and the ViT at 1120² (kv 6401, past the 4096
    # where the JAX package hands over to the library's flash kernel), each in
    # bf16 and float32
    other = [(2, 1024, 2, 32, 32**-0.5), (2, 1024, 1, 128, 128**-0.5), (2, 1024, 8, 12, 12**-0.5),
             (1, 6401, 16, 64, 64**-0.5), (2, 1024, 1, 256, 256**-0.5), (2, 1024, 1, 320, 320**-0.5),
             (2, 1024, 1, 384, 384**-0.5), (2, 1024, 1, 512, 512**-0.5)]
    # the six shapes contiguous, then the two ViT shapes as slices of a fused
    # qkv projection (token stride 3·H·D), which is how the ViT calls K1; the
    # six in float32 (the matcher built with dtype=torch.float32, and `learn`);
    # in bf16 D=128 and 320 with many blocks (no kv split), D=320 as slices
    # of a fused projection (the wide kernel's maps over strided tokens), and
    # D=300 (q, k and v padded to 320) on q of 77 rows and kv of 130 keys (a
    # 6th entry)
    cases = ([(shape, False, bf16) for shape in shapes] + [(shape, True, bf16) for shape in shapes[:2]]
             + [(shape, False, f32) for shape in shapes]
             + [(shape, False, dt) for shape in other for dt in (bf16, f32)]
             + [((16, 1024, 1, 128, 128**-0.5), False, bf16), ((16, 1024, 1, 320, 320**-0.5), False, bf16),
                ((2, 1024, 1, 320, 320**-0.5), True, bf16), ((1, 77, 2, 300, 300**-0.5, 130), False, bf16)])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, wide = [], None
    for (b, n, h, d, scale, *rest), fused, dtype in cases:
        nk = rest[0] if rest else n
        if fused:
            qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((b, nk, h, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
        merges, before = counters().get("k1.merges", 0), kernels.k1_kernel_counts()
        got = kernels.oneshot_attention(q, k, v, scale).float()
        merged = counters().get("k1.merges", 0) - merges
        # the CUDA kernel the library reports it launched for this call
        route = [name for name, n in kernels.k1_kernel_counts().items() if n != before.get(name, 0)]
        if len(route) != 1:
            raise AssertionError(f"K1 {(b, n, h, d)}: one call reported the kernels {route}")
        want = scaled_dot_product_attention(q.float(), k.float(), v.float(), scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        dk, dv = kernels.attention_head_dim(d), kernels.attention_value_dim(d, dtype == bf16)
        splits, kv_split = kernels.attention_splits(dtype == bf16, b, n, nk, h, dk, dv, sms)
        atol = K1_ATOL if dtype == bf16 else K1_F32_ATOL
        row = {"shape": [b, n, h, d], "kv": nk, "dtype": str(dtype).split(".")[-1], "fused_qkv_slices": fused,
               "route": route[0],
               "kernel_head_dim": dk, "kernel_value_dim": dv, "kv_splits": splits, "merge_launched": merged,
               "scale": scale, "max_abs_err": err, "max_rel_err": rel, "atol": atol,
               "kernel_ms": cuda_ms(torch, lambda: kernels.oneshot_attention(q, k, v, scale), 20),
               "plain_ms": cuda_ms(torch, lambda: scaled_dot_product_attention(q, k, v, scale), 5),
               "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), 20)}
        # the function's work at its own D (a padded launch does more); a
        # float32 product is three TF32 products on the tensor cores, and the
        # float32 SIMT figure is kept beside it
        flops, exps, elems = 4 * b * n * nk * h * d, b * h * n * nk, 2 * b * (n + nk) * h * d
        if dtype == bf16:
            row["bound_ms"], row["bound_by"] = bound([(flops, PEAK_BF16_FLOPS)], elems * 2, exps, exp_rate)
        else:
            row["bound_ms"], row["bound_by"] = bound([(3 * flops, PEAK_TF32_FLOPS)], elems * 4, exps, exp_rate)
            row["bound_simt_ms"], row["bound_simt_by"] = bound([(flops, PEAK_F32_FLOPS)], elems * 4, exps, exp_rate)
        if dtype == bf16 and (b == 2 or d > 256):
            # the kernels' own schedule in PyTorch, in bf16 as the kernel runs
            # it (above 256 the logits summed one 64-channel box at a time)
            streamed = streamed_attention_plain(q, k, v, scale, box=64 if d > 256 else None).float()
            row["max_rel_err_vs_streamed"] = ((got - streamed).abs().max() / streamed.abs().max()).item()
            row["streamed_rtol"] = K1_STREAMED_RTOL
        emit("k1", **row)
        if not err <= atol:
            raise AssertionError(f"K1 {row['shape']} {row['dtype']}: max abs err {err} > {atol}")
        if not row.get("max_rel_err_vs_streamed", 0.0) <= K1_STREAMED_RTOL:
            raise AssertionError(f"K1 {row['shape']} against its streamed plain version: "
                                 f"{row['max_rel_err_vs_streamed']} > {K1_STREAMED_RTOL}")
        if merged != (splits > 1):
            raise AssertionError(f"K1 {row['shape']} {row['dtype']}: {merged} merges for {splits} kv splits")
        rows.append(row)
        if (b, n, h, d) == (2, 1024, 1, 320) and dtype == bf16 and not fused:
            wide = row

    k1_host_cost(torch, (shapes[0], shapes[2]))
    # the inference path's slowest shape, and the wide kernel's first row
    return max(rows[:4], key=lambda r: r["kernel_ms"]), wide


def host_cost(torch, phase: str, cases: dict, launchers: dict) -> dict:
    """What one launch costs the host, in µs: 200 calls without a synchronise
    between them, five times over, the least and the median, for each case
    (label → the launchers' arguments) and launcher (name → function). The
    host's clock spreads from process to process, so two launchers are
    compared only in turns within one process."""
    import statistics

    host = {}
    for label, args in cases.items():
        runs = {name: [] for name in launchers}
        for _ in range(6):  # the first turn warms up and is dropped
            for name, fn in launchers.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn(*args)
                runs[name].append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
        host[label] = {name: {"min_us": min(r[1:]), "median_us": statistics.median(r[1:])}
                       for name, r in runs.items()}
    emit(phase, **host)
    return host


def k1_host_cost(torch, shapes, launchers: dict | None = None) -> dict:
    """The host's cost of a K1 launch at each (B, N, H, D, scale) of
    `shapes` (B=1 inference launches K1 56 times a pair and is bound by the
    host); `launchers` as in `host_cost`, by default this checkout's."""
    if launchers is None:
        from gfnet_tpu_torch.ops import kernels
        launchers = {"oneshot_attention": kernels.oneshot_attention}
    gen = torch.Generator("cuda").manual_seed(11)
    cases = {f"D={d}": tuple(torch.randn((b, n, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                             for _ in range(3)) + (scale,)
             for b, n, h, d, scale in shapes}
    return host_cost(torch, "k1_host_us_per_launch", cases, launchers)


def k2_active_cells(torch, flow, h: int, w: int, r: int) -> int:
    """Cells whose (2r+2)² patch meets the map: K2 and K3 skip the rest."""
    from gfnet_tpu_torch.ops.local_correlation import _corr_windows

    return int((~_corr_windows(flow, h, w, r)[4]).sum().item())


# Flows that K2 and K3 are timed on at every shape (`eval/flows.FLOW_KINDS`
# says what each is); "staged_only" and "mixed" run at one shape each.
CORR_TIMED_FLOWS = ("homography", "random")


def corr_flow(torch, kind: str, b: int, g: int, t: int, seed: int):
    from gfnet_tpu_torch.eval.flows import kernel_flow

    return kernel_flow(kind, b, g, t, seed).cuda()


def corr_tiling(torch, flow, target, r: int, query_rows: bool, sched=None) -> dict:
    """How K2 (`query_rows`) or K3 tile this launch (`sched`, by default
    `kernels.corr_schedule`'s), the share of tiles that stage
    (`corr_tile_boxes`), and the target bytes each way: what the per-cell
    path reads through L2 for every cell whose window meets the map, what the
    staged boxes hold, and what the cells of unstaged tiles read."""
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.ops.local_correlation import _corr_windows, _tiles, corr_tile_boxes

    b, g1, g2, _ = flow.shape
    _, h, w, c = target.shape
    elem = target.element_size()
    sched = sched or kernels.corr_schedule(r, c, elem, h, w, g1, g2, b, query_rows)
    _, staged = corr_tile_boxes(flow, h, w, r, sched.tile, sched.box)
    inside = _tiles(~_corr_windows(flow, h, w, r)[4], sched.tile, False)
    patch = (2 * r + 2) ** 2 * c * elem
    return {"tile": list(sched.tile), "box": list(sched.box), "chunk": sched.chunk,
            "staged_share": staged.float().mean().item(),
            "percell_l2_bytes": int(inside.sum().item()) * patch,
            "staged_box_bytes": int(staged.sum().item()) * sched.box[0] * sched.box[1] * c * elem,
            "unstaged_cell_bytes": int(inside[~staged].sum().item()) * patch}


def timed_in_turns(torch, fns: dict, iters: int) -> dict:
    """`<name>_ms` of each function of `fns` (name → function; None is
    skipped); of two or more, each twice, in turns forward and back (a, b, c,
    c, b, a), `<name>_ms` the mean of its two runs `<name>_ms_runs`."""
    fns = {name: fn for name, fn in fns.items() if fn is not None}
    order = list(fns) + list(fns)[::-1] if len(fns) > 1 else list(fns)
    runs = {name: [] for name in fns}
    for name in order:
        runs[name].append(cuda_ms(torch, fns[name], iters))
    out = {}
    for name, r in runs.items():
        out[f"{name}_ms"] = sum(r) / len(r)
        if len(r) > 1:
            out[f"{name}_ms_runs"] = r
    return out


def unstaged_schedule(r: int, c: int, elem: int, sched, query_rows: bool):
    """`sched` with a box of one window: a tile stages only where all its
    cells share one patch, so nearly every cell reads its patch from global
    memory, its tile's neighbours through L1. Against the staged schedule on
    a homography flow, this times what staging buys."""
    from gfnet_tpu_torch.ops import kernels

    win = 2 * r + 2
    return kernels.corr_layout(r, c, elem, sched.tile, (win, win), sched.chunk, query_rows)


def corr_ops(active: int, r: int, c: int, dot_rate: float) -> list:
    """K2's and K3's operations a launch, as `bound` takes them: per cell
    whose window meets the map, a multiply-add per patch value (at the rate
    of the operands' type, `dot_rate`) and 7 float32 operations a tap (the
    four-corner combine, or the spread of the gradient)."""
    from gfnet_tpu_torch.utils.profiling import PEAK_F32_FLOPS

    return [(active * 2 * (2 * r + 2) ** 2 * c, dot_rate), (active * 7 * (2 * r + 1) ** 2, PEAK_F32_FLOPS)]


def check_corr_branches(name: str, rows: list) -> None:
    """Both branches ran at full width: a launch with every tile staged, one
    with none, one with both."""
    shares = [row["staged_share"] for row in rows]
    if not (1.0 in shares and 0.0 in shares and any(0.0 < x < 1.0 for x in shares)):
        raise AssertionError(f"{name}: staged shares {shares} miss a branch case")


def phase_k2(torch, against=None) -> dict:
    """K2 (bf16, one pair) against its plain version at every main-path shape
    on the homography and the random flow, then the branch cases and the
    zero windows. `against`: another checkout's `kernels` module, whose K2 is
    timed beside this one. Returns the homography row of the slowest shape,
    with the random flow's time beside it."""
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.ops.local_correlation import _local_correlation_patch, local_corr_tiled_plain
    from gfnet_tpu_torch.utils.profiling import PEAK_BF16_FLOPS, bound

    gen = torch.Generator("cuda").manual_seed(2)
    # (radius, C, target side, grid side) of every refiner with r > 0 in
    # pass 1 (448²) and pass 2 (560²), B' = 2; then the branch cases at the
    # slowest of them
    shapes = [(7, 64, 32, 32), (6, 64, 56, 32), (6, 64, 70, 40), (4, 32, 112, 64),
              (4, 32, 140, 80), (2, 16, 224, 128), (2, 16, 280, 160)]
    cases = [(shape, kind) for shape in shapes for kind in CORR_TIMED_FLOWS]
    cases += [((6, 64, 70, 40), kind) for kind in ("staged_only", "mixed")]
    rows = []
    for i, ((r, c, t, g), kind) in enumerate(cases):
        b = 2
        query = torch.randn((b, g, g, c), generator=gen, device="cuda").to(torch.bfloat16)
        target = torch.randn((b, t, t, c), generator=gen, device="cuda").to(torch.bfloat16)
        flow = corr_flow(torch, kind, b, g, t, 20 + i)
        got = kernels.local_corr(query, target, flow, r)
        want = _local_correlation_patch(query, target, flow, r)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        row = {"radius": r, "query": [b, g, g, c], "target": [b, t, t, c], "flow": kind,
               "max_abs_err": err, "atol": K2_ATOL}
        fns = {"kernel": lambda: kernels.local_corr(query, target, flow, r),
               "earlier": against and (lambda: against.local_corr(query, target, flow, r))}
        tiling = corr_tiling(torch, flow, target, r, True)
        if kind == "homography":  # against the same tiles with staging off
            sched = kernels.corr_schedule(r, c, 2, t, t, g, g, b, True)
            off = unstaged_schedule(r, c, 2, sched, True)
            fns["unstaged"] = lambda: kernels.local_corr(query, target, flow, r, off)
            row["unstaged_max_abs_err"] = (fns["unstaged"]() - want).abs().max().item()
            row["unstaged_staged_share"] = corr_tiling(torch, flow, target, r, True, off)["staged_share"]
            err = max(err, row["unstaged_max_abs_err"])
        row.update(timed_in_turns(torch, fns, 20))
        row.update(plain_ms=cuda_ms(torch, lambda: _local_correlation_patch(query, target, flow, r), 3),
                   library_ms=None)
        if kind in ("staged_only", "mixed"):  # the plain version that repeats the kernel's schedule
            tiled = local_corr_tiled_plain(query, target, flow, r, tiling["tile"], tiling["box"])
            row["max_abs_err_vs_tiled"] = (got - tiled).abs().max().item()
            err = max(err, row["max_abs_err_vs_tiled"])
        nbytes = 2 * (query.numel() + target.numel()) + 4 * (flow.numel() + got.numel())
        active = k2_active_cells(torch, flow, t, t, r)
        # bf16 × bf16 dots, accumulated in float32, at the bf16 rate
        row["bound_ms"], row["bound_by"] = bound(corr_ops(active, r, c, PEAK_BF16_FLOPS), nbytes)
        row["active_cells"] = active
        row.update(tiling)
        emit("k2", **row)
        if not err <= K2_ATOL:
            raise AssertionError(f"K2 r={r} t={t} g={g} {kind} flow: max abs err {err} > {K2_ATOL}")
        rows.append(row)
    check_corr_branches("K2 bf16", rows)
    for name, value in (("far_out_of_range", 5.0), ("nan", math.nan)):
        query = torch.randn((2, 32, 32, 64), generator=gen, device="cuda").to(torch.bfloat16)
        target = torch.randn((2, 32, 32, 64), generator=gen, device="cuda").to(torch.bfloat16)
        flow = torch.full((2, 32, 32, 2), value, device="cuda")
        out = kernels.local_corr(query, target, flow, 7)
        zeros = bool((out == 0).all().item())
        emit("k2_zero_window", case=name, all_zero=zeros)
        if not zeros:
            raise AssertionError(f"K2 {name} flow did not give an all-zero window")
    corr_host_cost(torch, "k2_host_us_per_launch", kernels.local_corr, against and against.local_corr,
                   (7, 64, 32, 32, 2, torch.bfloat16))
    corr_padded_channels(torch)
    return summary_row(rows)


def corr_padded_channels(torch) -> None:
    """K2 and K3 at a channel count TMA cannot stage as it is: C = 12 in bf16
    (24-byte pixels) at pass 1's r = 2 shape on the homography flow, through
    `local_correlation` (zero-padded to 16 channels, the caller's 1/√12),
    against the plain versions at C = 12; K3 twice, bitwise equal."""
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.ops.local_correlation import (_local_correlation_patch, local_corr_dq_plain,
                                                       local_correlation, pad_channels)
    from gfnet_tpu_torch.utils.profiling import PEAK_BF16_FLOPS, bound

    gen = torch.Generator("cuda").manual_seed(12)
    r, c, t, g, b = 2, 12, 224, 128, 2
    query = torch.randn((b, g, g, c), generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
    target = torch.randn((b, t, t, c), generator=gen, device="cuda").to(torch.bfloat16)
    flow = corr_flow(torch, "homography", b, g, t, 31)
    grad = torch.randn((b, g, g, (2 * r + 1) ** 2), generator=gen, device="cuda")
    before = kernels.launch_counts()
    out = local_correlation(query, target, flow, r)
    (dq,) = torch.autograd.grad(out, query, grad)
    launched = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    padded = pad_channels(target)
    k3 = lambda: kernels.local_corr_bwd(grad, padded, flow, r, scale=1.0 / math.sqrt(c))[..., :c]
    first, again = k3(), k3()
    q = query.detach()
    want2, want3 = _local_correlation_patch(q, target, flow, r), local_corr_dq_plain(grad, target, flow, r)
    torch.cuda.synchronize()
    row = {"radius": r, "query": [b, g, g, c], "target": [b, t, t, c], "dtype": "bfloat16", "flow": "homography",
           "padded_to": padded.shape[-1], "launches": launched,
           "k2_max_abs_err": (out - want2).abs().max().item(), "k2_atol": K2_ATOL,
           "k3_max_abs_err": (first - want3).abs().max().item(), "k3_atol": K3_ATOL,
           # through autograd dq comes back in the query's bf16
           "k3_autograd_max_abs_err_vs_bf16": (dq.float() - want3.to(dq.dtype).float()).abs().max().item(),
           "k3_bitwise_repeatable": bool(torch.equal(first, again)),
           "k2_ms": cuda_ms(torch, lambda: local_correlation(q, target, flow, r), 20),
           "k2_plain_ms": cuda_ms(torch, lambda: _local_correlation_patch(q, target, flow, r), 3),
           "k3_ms": cuda_ms(torch, k3, 20),
           "k3_plain_ms": cuda_ms(torch, lambda: local_corr_dq_plain(grad, target, flow, r), 3)}
    # the function's work at its own C = 12: bf16 dots at the bf16 rate;
    # bytes of query, target, flow and windows (K2) or gradient and dq (K3)
    active = k2_active_cells(torch, flow, t, t, r)
    ops = corr_ops(active, r, c, PEAK_BF16_FLOPS)
    row["k2_bound_ms"], row["k2_bound_by"] = bound(
        ops, 2 * (q.numel() + target.numel()) + 4 * (flow.numel() + out.numel()))
    row["k3_bound_ms"], row["k3_bound_by"] = bound(
        ops, 2 * target.numel() + 4 * (flow.numel() + grad.numel() + first.numel()))
    emit("corr_padded_channels", **row)
    if launched != {"oneshot_attention": 0, "local_corr": 1, "local_corr_bwd": 1, "kde": 0, "residual_norm": 0,
                    "refine_block": 0}:
        raise AssertionError(f"padded-channel correlation launches {launched}")
    if not (row["k2_max_abs_err"] <= K2_ATOL and row["k3_max_abs_err"] <= K3_ATOL
            and row["k3_bitwise_repeatable"]):
        raise AssertionError(f"K2/K3 at C = {c}: {row}")


def corr_host_cost(torch, phase: str, launcher, earlier, shape) -> dict:
    """The host's cost of a K2 or K3 launch (`host_cost`) at one (radius, C,
    target side, grid side, batch, dtype) shape on a homography flow, beside
    `earlier`'s (another checkout's) in turns where it is given."""
    r, c, t, g, b, dtype = shape
    gen = torch.Generator("cuda").manual_seed(12)
    first = (torch.randn((b, g, g, c), generator=gen, device="cuda").to(dtype) if phase.startswith("k2")
             else torch.randn((b, g, g, (2 * r + 1) ** 2), generator=gen, device="cuda"))
    target = torch.randn((b, t, t, c), generator=gen, device="cuda").to(dtype)
    case = {f"r{r} q{g} t{t} C{c} B{b} {str(dtype).split('.')[-1]}": (first, target, corr_flow(torch, "homography", b, g, t, 13), r)}
    launchers = {"this": launcher, "earlier": earlier} if earlier is not None else {"this": launcher}
    return host_cost(torch, phase, case, launchers)


def summary_row(rows: list) -> dict:
    """The homography row of the slowest shape, with the random flow's time
    at that shape beside it."""
    homog = [row for row in rows if row["flow"] == "homography"]
    row = dict(max(homog, key=lambda r: r["kernel_ms"]))
    same = lambda r: all(r.get(k) == row.get(k) for k in ("radius", "query", "grad", "target", "target_dtype"))
    row["ms_random_flow"] = next(r["kernel_ms"] for r in rows if r["flow"] == "random" and same(r))
    return row


def smooth_images(np, rng, b: int, h: int, w: int):
    """Seeded smooth random RGB images in [0, 1] (B, H, W, 3)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img = np.zeros((b, h, w, 3), np.float32)
    for _ in range(12):
        f = rng.uniform(1, 12, (b, 1, 1, 3))
        ph = rng.uniform(0, 2 * np.pi, (b, 1, 1, 3))
        ang = rng.uniform(0, np.pi, (b, 1, 1, 3))
        img += np.sin(2 * np.pi * f * (np.cos(ang) * xx[None, ..., None]
                                       + np.sin(ang) * yy[None, ..., None]) + ph)
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


def tiny_setup(torch, np):
    """The tiny config on CUDA and on the CPU, float32, with the same weights
    (seeded random ViT, the trained tiny head: its refiners move the warp,
    where seeded random ones add ~1e-6), and two seeded images."""
    from gfnet_tpu_torch.config import tiny_test_config
    from gfnet_tpu_torch.matcher import GFNetMatcher
    from gfnet_tpu_torch.utils.convert import load_head_npz

    head, kv_norm = load_head_npz(str(TINY_HEAD))
    cfg = tiny_test_config().with_kv_norm(kv_norm)
    rng = np.random.default_rng(3)
    a = smooth_images(np, rng, 1, 100, 120)[0]
    b = smooth_images(np, rng, 1, 90, 110)[0]
    gpu, cpu = (GFNetMatcher(cfg, device=dev, dtype=torch.float32, head_state=head, seed=0)
                for dev in ("cuda", "cpu"))
    return gpu, cpu, a, b


def phase_tiny(torch, np) -> None:
    from gfnet_tpu_torch.ops import kernels

    gpu, cpu, a, b = tiny_setup(torch, np)
    kernels.reset_launch_counts()
    wg, cg = gpu.match(a, b)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wc, cc = cpu.match(a, b)
    werr = (wg.cpu() - wc).abs().max().item()
    cerr = (cg.cpu() - cc).abs().max().item()
    emit("tiny_cuda_vs_cpu", warp_max_abs_err=werr, certainty_max_abs_err=cerr, atol=E2E_ATOL,
         launches=counts, warp_shape=list(wg.shape))
    if (counts["oneshot_attention"] == 0 or counts["local_corr"] == 0 or counts["local_corr_bwd"] != 0
            or counts["refine_block"] != k6_launches_a_match(gpu.cfg)):
        raise AssertionError(f"tiny inference path on CUDA: launches {counts}")
    if not (werr <= E2E_ATOL and cerr <= E2E_ATOL):
        raise AssertionError(f"tiny path CUDA vs CPU: warp {werr}, certainty {cerr} > {E2E_ATOL}")


def phase_flagship(torch, np) -> dict:
    from gfnet_tpu_torch.matcher import GFNetMatcher
    from gfnet_tpu_torch.ops import kernels

    import gfnet_tpu_torch.matcher.api as api

    draw, real_draw = {}, api.jax_vit_state

    def timed_draw(*args, **kw):  # the backbone's draw, timed on its own
        t = time.perf_counter()
        out = real_draw(*args, **kw)
        draw["seconds"] = time.perf_counter() - t
        return out

    t0 = time.perf_counter()
    api.jax_vit_state = timed_draw
    try:
        m = GFNetMatcher.from_pretrained(ckpt_path=str(HEAD_NPZ), device="cuda", dtype=torch.bfloat16, seed=0)
    finally:
        api.jax_vit_state = real_draw
    cfg = m.cfg
    setup_s = time.perf_counter() - t0
    emit("flagship_setup", setup_s=setup_s, backbone_draw_s=draw["seconds"],
         backbone="jax_vit_state(ModelConfig(), seed=0)")
    if not cfg.dino.decoder_cfg.kv_norm:
        raise AssertionError("the r5b head should switch kv_norm on")
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(smooth_images(np, rng, 16, 448, 448)).cuda()
    a1, b1 = imgs[0], imgs[1]
    a8, b8 = imgs[:8], imgs[8:]

    passes = 2 if cfg.upsample_preds else 1
    want_k1 = passes * (cfg.dino.depth + cfg.dino.decoder_cfg.num_cross_attn)
    want_k2 = sum(r > 0 for r in cfg.matcher.radius) + sum(r > 0 for r in cfg.matcher.radius[1:])
    want = {"oneshot_attention": want_k1, "local_corr": want_k2, "local_corr_bwd": 0, "kde": 1,
            "residual_norm": passes * (3 * cfg.dino.depth + 1), "refine_block": k6_launches_a_match(cfg)}

    m.estimate_homography(a1, b1)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    candidates, real_kde = [], api.kde

    def kept_kde(x, *args, **kw):  # the sampled candidates, for the k4 phase (on the host: no device bytes)
        candidates.append(x.detach().cpu())
        return real_kde(x, *args, **kw)

    api.kde = kept_kde
    try:
        kernels.reset_launch_counts()
        H = m.estimate_homography(a1, b1, key=None)  # PRNGKey(0)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        k1_kernels = kernels.k1_kernel_counts()  # K1's calls by the CUDA kernel launched
        peak_single = torch.cuda.max_memory_allocated()

        kernels.reset_launch_counts()
        Hb = m.estimate_homography_batched(a8, b8, key=None)
        torch.cuda.synchronize()
        counts_b = kernels.launch_counts()
        peak_batched = torch.cuda.max_memory_allocated()
    finally:
        api.kde = real_kde

    ok = (tuple(H.shape) == (3, 3) and tuple(Hb.shape) == (8, 3, 3)
          and bool(torch.isfinite(H).all()) and bool(torch.isfinite(Hb).all()))
    emit("flagship_outputs", H=H.cpu().tolist(), H_batched_finite=bool(torch.isfinite(Hb).all()),
         H_batched_shape=list(Hb.shape), launches_single=counts, launches_batched=counts_b,
         expected_launches=want, k1_kernels_single=k1_kernels)
    if not ok:
        raise AssertionError("flagship homographies are not finite (3,3)/(8,3,3)")
    if counts != want or counts_b != counts:
        raise AssertionError(f"launch counts {counts} / {counts_b}, expected {want}")
    if sum(k1_kernels.values()) != counts["oneshot_attention"]:
        raise AssertionError(f"K1's kernels {k1_kernels} do not add up to its {counts['oneshot_attention']} calls")

    # throughput (host clock around synchronized calls)
    def timed(fn, reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps

    single_s = timed(lambda: m.estimate_homography(a1, b1), 3)
    batched_s = timed(lambda: m.estimate_homography_batched(a8, b8), 2)
    split = {1: phase_split(torch, m, a1[None], b1[None]), 8: phase_split(torch, m, a8, b8)}
    for bsz, run in ((1, lambda: m.estimate_homography(a1, b1)), (8, lambda: m.estimate_homography_batched(a8, b8))):
        emit("corr_model_flows", path="estimate_homography", batch=bsz, launches=corr_model_flows(torch, run))
    result = {"setup_s": setup_s, "backbone_draw_s": draw["seconds"], "single_pairs_per_s": 1.0 / single_s,
              "batched_B": 8, "batched_pairs_per_s": 8.0 / batched_s,
              "phase_ms": {b: {k: v["wall_ms"] for k, v in sp.items()} for b, sp in split.items()},
              "phase_device_ms": {b: {k: v["device_kernel_ms"] for k, v in sp.items()}
                                  for b, sp in split.items()},
              "max_memory_allocated_single": peak_single,
              "max_memory_allocated_batched": peak_batched, "launches": counts, "k1_kernels": k1_kernels}
    emit("flagship", **result)
    return result, m, {"batched": candidates[1], "single": candidates[0]}


def fma_dots(a, y):
    """a (B, M, 4) · y (B, N, 4)ᵀ in float32 as K4 forms it: x0·y0, then
    + x1·y1, + x2·y2, + x3·y3, each a fused multiply-add. Emulated in
    float64, where a product of two float32 is exact and a sum rounds to
    float32 as the FMA does but for rare double roundings."""
    a, y = a.double(), y.double()
    acc = (a[..., :, None, 0] * y[..., None, :, 0]).float()
    for k in (1, 2, 3):
        acc = (a[..., :, None, k] * y[..., None, :, k] + acc.double()).float()
    return acc


def phase_k4(torch, exp_rate: float, candidates: dict) -> dict:
    """K4 on the flagship's sampled candidates (`phase_flagship`): (8, N, 4)
    and (1, N, 4), bit for bit against the plain path and itself, its
    dots against cuBLAS's, timed in turns with the plain path; the bound is
    B·N² exponentials at `exp_rate`. Returns the batched row."""
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.ops.kde import kde_plain

    inv = -1.0 / (2 * 0.1 * 0.1)
    rows = {}
    for name in ("batched", "single"):
        x = candidates[name].float().cuda()
        x = x.reshape(-1, x.shape[-2], 4).contiguous()
        b, n, _ = x.shape
        sq = (x * x).sum(-1)
        got = kernels.kde(x, sq, inv)
        want = kde_plain(x, std=0.1)
        rel = ((got - want).abs() / want.abs()).max().item()
        cublas = x[:, :256] @ x.mT  # the plain path's dots, 256 rows of each member
        row = {"shape": [b, n, 4], "bitwise_equal_plain": bool(torch.equal(got, want)), "max_rel_diff": rel,
               "max_abs_err": (got - want).abs().max().item(),
               "bitwise_repeatable": bool(torch.equal(got, kernels.kde(x, sq, inv))),
               "dot_bits_equal_share": (cublas == fma_dots(x[:, :256], x)).double().mean().item(),
               "cut_crossings": int(((got < 10) != (want < 10)).sum().item()),
               "density_below_10_share": (want < 10).double().mean().item()}
        row.update(timed_in_turns(torch, {"kernel": lambda: kernels.kde(x, sq, inv)}, 20))
        row.update(plain_ms=cuda_ms(torch, lambda: kde_plain(x, std=0.1), 3), library_ms=None,
                   bound_ms=b * n * n / exp_rate * 1e3, bound_by="exp")
        emit("k4", **row)
        if not (row["bitwise_equal_plain"] and row["bitwise_repeatable"]):
            raise AssertionError(f"K4 at {row['shape']}: {row}")
        rows[name] = row
    return rows["batched"]


K5_SHAPES = {"vitl": (16 * 1601, 1024), "vitg": (16 * 1605, 1536)}  # rows of a batch call's 560² pass, D
K5_USES = {"norm": ("x", "weight", "bias"), "add_norm": ("x", "h", "gamma", "weight", "bias"),
           "add": ("x", "h", "gamma")}
K5_FLOPS = {"norm": 7, "add_norm": 9, "add": 2}  # float32 operations an element
# K5's bf16 n against the plain path's: one bf16 ulp of the value, plus
# float32 rounding of the norm's terms. The two sum a row's mean and variance
# in different orders, so their float32 n differ by a few 2^-24 of the terms,
# weight·rstd·(|s − mean| + max|s|) + |bias|; where those cancel to a value
# far below them, that is many of the value's own ulps (on an H100: up to 163
# at ~1e-5, on 6e-5 of elements), and 2^-16 of the terms leaves 256 float32
# roundings.
K5_TERMS_REL = 2.0**-16
K5_DIFFER_SHARE = 0.01  # n off the plain path's at all: a value next to a bf16 rounding boundary


def bf16_ordinal(torch, t):
    """bf16 values as integers in their order, one apart per ulp (±0 both 0)."""
    bits = t.contiguous().view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def k5_norm_error(torch, n, want, s, weight, bias, eps: float = 1e-6) -> dict:
    """How far K5's bf16 n lies from the plain path's `want` over the rows s
    it normalised: the most ulps apart, the share of elements that differ,
    and the elements beyond one ulp of `want` plus `K5_TERMS_REL` of the
    norm's terms (`k5_ok` when none and the share is under `K5_DIFFER_SHARE`)."""
    sf = s.float()
    var, mean = torch.var_mean(sf, -1, unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    terms = weight.float().abs() * rstd * ((sf - mean).abs() + sf.abs().amax(-1, keepdim=True)) + bias.float().abs()
    a = want.abs().contiguous()
    ulp = (a.view(torch.int16) + 1).view(torch.bfloat16).float() - a.float()
    over = int(((n.float() - want.float()).abs() > ulp + K5_TERMS_REL * terms).sum())
    apart = (bf16_ordinal(torch, n) - bf16_ordinal(torch, want)).abs()
    share = float((apart > 0).double().mean())
    return {"n_max_ulps": int(apart.max()), "n_differ_share": share, "n_over_tolerance": over,
            "k5_ok": over == 0 and share < K5_DIFFER_SHARE}


def k5_inputs(torch, rows: int, d: int, dtype, device, seed: int = 0) -> dict:
    """K5's tensors from `seed`: x and h (rows, d), a stream whose offset and
    spread differ by row, so that each row's mean and variance matter; gamma,
    weight and bias (d,), weight about 1, bias and gamma about 0."""
    gen = torch.Generator(device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)
    x = rnd(rows, d) * (0.5 + rnd(rows, 1).abs()) + rnd(rows, 1)
    return {"x": x.to(dtype), "h": rnd(rows, d).to(dtype), "gamma": (0.1 * rnd(d)).to(dtype),
            "weight": (1 + 0.3 * rnd(d)).to(dtype), "bias": (0.2 * rnd(d)).to(dtype)}


def phase_k5(torch) -> dict:
    """K5 at `K5_SHAPES` in bf16, each of `K5_USES`, against the plain path
    (the card test's gates: s bit for bit, `k5_norm_error`) and timed in turns
    with it; the bound is the bytes read and written (2 a bf16 element of
    each tensor in and out) over the memory rate. Returns the add-and-norm
    row at the ViT-g-reg shape."""
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.ops.residual_norm import residual_norm_plain
    from gfnet_tpu_torch.utils.profiling import PEAK_F32_FLOPS, bound

    rows_out = {}
    for shape_name, (rows, d) in K5_SHAPES.items():
        t = k5_inputs(torch, rows, d, torch.bfloat16, "cuda", seed=rows)
        for use, names in K5_USES.items():
            kw = {k: t[k] for k in names}
            with torch.no_grad():
                s, n = kernels.residual_norm(**kw)
                want_s, want_n = residual_norm_plain(**kw)
            row = {"shape": [rows, d], "use": use, "dtype": "bfloat16", "s_bitwise_equal": bool(torch.equal(s, want_s))}
            if n is not None:
                row.update(k5_norm_error(torch, n, want_n, want_s, t["weight"], t["bias"]),
                           max_abs_err=float((n.float() - want_n.float()).abs().max()))
            else:
                row["max_abs_err"] = float((s.float() - want_s.float()).abs().max())
            tensors = len(names) - (1 if "gamma" in names else 0) - (2 if "weight" in names else 0)
            written = int("h" in names) + int("weight" in names)
            nbytes = (tensors + written) * rows * d * 2
            with torch.no_grad():
                row.update(timed_in_turns(torch, {"kernel": lambda: kernels.residual_norm(**kw),
                                                  "plain": lambda: residual_norm_plain(**kw)}, 20))
            row["bound_ms"], row["bound_by"] = bound([(K5_FLOPS[use] * rows * d, PEAK_F32_FLOPS)], nbytes)
            row.update(bytes=nbytes, library_ms=None, times_bound=row["kernel_ms"] / row["bound_ms"])
            emit("k5", **row)
            if not (row["s_bitwise_equal"] and row.get("k5_ok", True)):
                raise AssertionError(f"K5 at {row['shape']} ({use}): {row}")
            rows_out[(shape_name, use)] = row
    return rows_out[("vitg", "add_norm")]


# K6: (B', G, C) of the refine blocks of a basic batch call, pass 1 at 448², pass 2 at 560²
K6_SHAPES = ((16, 32, 417), (16, 32, 361), (16, 64, 177), (16, 128, 73), (16, 256, 24),
             (16, 40, 361), (16, 80, 177), (16, 160, 73), (16, 320, 24))
K6_SINGLE = tuple((2, g, c) for _, g, c in K6_SHAPES)  # a single pair's call (the serve cell, the flagship)
K6_BLOCKS = 9  # refine blocks a refiner call: block1 and eight hidden
K6_FLOPS = 2 * 25 + 5  # float32 operations an element: the taps' FMAs, the bias, the BatchNorm, the ReLU
# K6's output against the plain chain's. The two sum the 25 taps in other
# orders, so their float32 sums differ by a few 2^-24 of the terms Σ|x·w|;
# that moves s by one bf16 ulp where the sum lay next to a rounding boundary,
# and by more only where the taps cancel to far below their terms. Each
# element may lie |mul|·(ulp(s) + K6_TERMS_REL·terms) + ulp(out) off (25
# terms summed in two orders differ by at most 50·2^-24 ≈ 2^-18.4 of them);
# a tap dropped or misplaced moves an output by about terms / 25.
K6_TERMS_REL = 2.0**-16
K6_DIFFER_SHARE = 0.01  # bf16 outputs off the plain path's at all
# In float32 nothing rounds to bf16: K6 and the plain chain differ by the
# taps' order (K6_TERMS_REL of the terms, through |mul|) and by where each
# of the BatchNorm's three float32 roundings falls, at most 2^-24 of the
# magnitudes it rounds (|s| + |mean| through |mul|, and |beta|) per side and
# operation; K6_F32_ROUND allows 16 of them.
K6_F32_ROUND = 2.0**-20


def k6_launches_a_match(cfg) -> int:
    """K6 launches a `match()` of a model of `cfg` on the card: nine a refiner
    call, each scale's refiner `num_itr` times a pass, pass 2 on the finer
    four scales."""
    itr = cfg.matcher.num_itr
    return K6_BLOCKS * (sum(itr) + (sum(itr[1:]) if cfg.upsample_preds else 0))


def k6_block(torch, c: int, device, seed: int = 0, dtype=None):
    """A refine block of width c (`models/refiner.RefineBlock`, computing in
    `dtype`, bf16 unless given; eval, no grad) with its weights and running
    statistics drawn from `seed`: taps of about 0.2, so that s is about x's
    size, a running variance in [0.5, 1.5), BatchNorm weights about 1."""
    from gfnet_tpu_torch.models.refiner import RefineBlock

    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen)
    blk = RefineBlock(c, 5, dtype or torch.bfloat16)
    with torch.no_grad():
        blk[0].weight.copy_(0.2 * rnd(c, 1, 5, 5))
        blk[0].bias.copy_(0.1 * rnd(c))
        blk[1].weight.copy_(1 + 0.2 * rnd(c))
        blk[1].bias.copy_(0.2 * rnd(c))
        blk[1].running_mean.copy_(0.3 * rnd(c))
        blk[1].running_var.copy_(0.5 + torch.rand(c, generator=gen))
        blk[3].weight.copy_(rnd(c, c, 1, 1) / c**0.5)
    return blk.to(device).eval().requires_grad_(False)


def k6_input(torch, b: int, h: int, w: int, c: int, device, seed: int = 0, dtype=None):
    """x (b, h, w, c) in `dtype` (bf16 unless given) from `seed`: unit
    normal, offset and spread by channel."""
    gen = torch.Generator(device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)
    return (rnd(b, h, w, c) * (0.5 + rnd(c).abs()) + 0.5 * rnd(c)).to(dtype or torch.bfloat16)


def k6_plain(torch, blk, x) -> tuple:
    """The plain chain's s (the depthwise conv's output in the block's
    dtype), mul (the BatchNorm's weight·rsqrt(var + eps)), output (after
    BatchNorm and ReLU) and the taps' terms Σ|x·w| + |bias| in float32,
    under no grad."""
    from gfnet_tpu_torch.models.common import conv_nhwc

    dw, bn = blk[0], blk[1]
    with torch.no_grad():
        s = dw(x)
        mul = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        out = blk[2](bn(s))
        terms = conv_nhwc(x.float().abs(), dw.weight.float().abs(), None, padding=2,
                          groups=x.shape[-1]) + dw.bias.float().abs()
    return s, mul, out, terms


def k6_error(torch, got, want, s, mul, terms, mean=None, beta=None) -> dict:
    """How far K6's output `got` lies from the plain chain's `want` (its s, mul
    and terms from `k6_plain`): the share of elements that differ (NaN equal
    to NaN), the elements beyond the tolerance, and where s or want is not
    finite, whether the two are equal. In bf16 the tolerance is |mul|·(ulp(s)
    + `K6_TERMS_REL`·terms) + ulp(want) (beyond the strict |mul|·ulp(s) +
    ulp(want) reported too, with the most bf16 ulps apart), and `k6_ok`
    also wants the share under `K6_DIFFER_SHARE`. In float32 (the
    BatchNorm's running `mean` and `beta` given) it is |mul|·`K6_TERMS_REL`·
    terms + `K6_F32_ROUND`·(|mul|·(|s| + |mean|) + |beta|), and any share
    passes: the taps' order moves most sums by an ulp."""
    g, wv = got.float(), want.float()
    same = (g == wv) | (torch.isnan(g) & torch.isnan(wv))
    exact = ~torch.isfinite(wv) | ~torch.isfinite(s.float())  # must match as they are
    diff = (g - wv).abs()
    share = float((~same).double().mean())
    exact_equal = bool(same[exact].all())
    row = {"dtype": str(got.dtype).removeprefix("torch."), "differ_share": share, "nonfinite": int(exact.sum()),
           "nonfinite_equal": exact_equal}
    if got.dtype == torch.float32:
        sf = s.float().abs().nan_to_num(posinf=0.0)
        tol = mul.abs() * (K6_TERMS_REL * terms + K6_F32_ROUND * (sf + mean.abs())) + K6_F32_ROUND * beta.abs()
        over = int((~exact & (diff > tol)).sum())
        return {**row, "max_rel_of_tolerance": float((diff / tol)[~exact].max()) if (~exact).any() else 0.0,
                "over_tolerance": over, "k6_ok": over == 0 and exact_equal}
    ulp = lambda t: (t.abs().contiguous().view(torch.int16) + 1).view(torch.bfloat16).float() - t.abs().float()
    strict = mul.abs() * ulp(s) + ulp(want)
    over = int((~exact & (diff > strict + mul.abs() * K6_TERMS_REL * terms)).sum())
    apart = (bf16_ordinal(torch, got) - bf16_ordinal(torch, want)).abs()[~exact]
    return {**row, "max_ulps": int(apart.max()) if apart.numel() else 0, "over_tolerance": over,
            "over_strict_tolerance": int((~exact & (diff > strict)).sum()),
            "k6_ok": over == 0 and exact_equal and share < K6_DIFFER_SHARE}


def k6_check(torch, kernels, blk, x) -> dict:
    """K6 on x against `blk`'s plain chain (`k6_error`), run twice: the
    error, whether the runs agree bit for bit, the largest |difference|."""
    dw, bn = blk[0], blk[1]
    params = (dw.weight, dw.bias, bn.running_mean, bn.running_var, bn.weight, bn.bias)
    with torch.no_grad():
        got, again = kernels.refine_block(x, *params, bn.eps), kernels.refine_block(x, *params, bn.eps)
        s, mul, want, terms = k6_plain(torch, blk, x)
        err = k6_error(torch, got, want, s, mul, terms, bn.running_mean, bn.bias)
    return {"bitwise_repeatable": bool(torch.equal(got, again)), **err,
            "max_abs_err": float((got.float() - want.float()).abs().nan_to_num().max())}


def phase_k6(torch) -> dict:
    """K6 at `K6_SHAPES` against the plain chain (the card test's gates:
    `k6_check`) and timed in turns with it; the bound is the bytes read and
    written (2 a bf16 element each way, and the parameters) over the memory
    rate. Untimed, the same gates at `K6_SINGLE` in bf16 and in float32 (TF32
    off). Returns the largest shape's row with the total of a call: each
    shape's ms times `K6_BLOCKS`."""
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.utils.profiling import PEAK_F32_FLOPS, bound

    rows, sms = [], torch.cuda.get_device_properties(0).multi_processor_count
    for i, (b, g, c) in enumerate(K6_SHAPES):
        blk = k6_block(torch, c, "cuda", seed=i)
        x = k6_input(torch, b, g, g, c, "cuda", seed=100 + i)
        dw, bn = blk[0], blk[1]
        params = (dw.weight, dw.bias, bn.running_mean, bn.running_var, bn.weight, bn.bias)
        row = {"shape": [b, g, g, c], "tile": list(kernels.refine_plan(b, g, g, c, sms)),
               **k6_check(torch, kernels, blk, x)}
        with torch.no_grad():
            row.update(timed_in_turns(torch, {"kernel": lambda: kernels.refine_block(x, *params, bn.eps),
                                              "plain": lambda: blk[2](bn(dw(x)))}, 20))
        n = b * g * g * c
        nbytes = 4 * n + c * (25 + 5) * 4
        row["bound_ms"], row["bound_by"] = bound([(K6_FLOPS * n, PEAK_F32_FLOPS)], nbytes)
        row.update(bytes=nbytes, library_ms=None, times_bound=row["kernel_ms"] / row["bound_ms"])
        emit("k6", **row)
        if not (row["k6_ok"] and row["bitwise_repeatable"]):
            raise AssertionError(f"K6 at {row['shape']}: {row}")
        rows.append(row)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the float32 plain chain in float32
    try:
        for dtype in (torch.bfloat16, torch.float32):
            for i, (b, g, c) in enumerate(K6_SINGLE):
                itemsize = torch.tensor([], dtype=dtype).element_size()
                blk = k6_block(torch, c, "cuda", seed=200 + i, dtype=dtype)
                x = k6_input(torch, b, g, g, c, "cuda", seed=300 + i, dtype=dtype)
                row = {"shape": [b, g, g, c], "tile": list(kernels.refine_plan(b, g, g, c, sms, itemsize)),
                       **k6_check(torch, kernels, blk, x)}
                emit("k6_untimed", **row)
                if not (row["k6_ok"] and row["bitwise_repeatable"]):
                    raise AssertionError(f"K6 at {row['shape']} {row['dtype']}: {row}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    total = {f"call_{k}": K6_BLOCKS * sum(r[k] for r in rows) for k in ("kernel_ms", "plain_ms", "bound_ms")}
    total["call_times_bound"] = total["call_kernel_ms"] / total["call_bound_ms"]
    emit("k6_call", blocks_a_refiner_call=K6_BLOCKS, **total)
    return {**rows[-1], **total}


def phase_flagship_f32(torch, np, m) -> dict:
    """The flagship in float32 (`GFNetMatcher(ModelConfig(), dtype=torch.float32)`,
    the JAX package's `GFNetMatcher(cfg, dtype=jnp.float32)`), B = 1, one
    448² pair, TF32 off: `match()` on the card (K1 on its float32 kernel)
    against the same weights (the bf16 matcher's ViT in float32, the r5b
    head) on the CPU (the plain versions), warp and certainty at the tiny
    gate's E2E_ATOL; each pass's ms (median of 5) and the K1 launches beside
    the bf16 matcher's."""
    import statistics

    from gfnet_tpu_torch.matcher import GFNetMatcher
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.utils.convert import load_head

    head, _ = load_head(str(HEAD_NPZ))
    vit = {k: v.float().cpu() for k, v in m.vit.state_dict().items()}
    gpu, cpu = (GFNetMatcher(m.cfg, device=dev, dtype=torch.float32, vit_state=vit, head_state=head)
                for dev in ("cuda", "cpu"))
    a, b = smooth_images(np, np.random.default_rng(5), 2, 448, 448)
    gpu.match(a, b)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    wg, cg = gpu.match(a, b)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    t0 = time.perf_counter()
    wc, cc = cpu.match(a, b)
    cpu_s = time.perf_counter() - t0
    werr, cerr = (wg.cpu() - wc).abs().max().item(), (cg.cpu() - cc).abs().max().item()

    x, y = (torch.from_numpy(im)[None].cuda() for im in (a, b))
    passes = {}
    for name, mm in (("float32", gpu), ("bfloat16", m)):
        with torch.inference_mode():
            pre = mm._pass1(x, y)
            for part, fn in (("pass1", lambda: mm._pass1(x, y)), ("pass2", lambda: mm._pass2(x, y, *pre))):
                walls = []
                for _ in range(6):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t1) * 1e3)
                passes[f"{name}_{part}_ms"] = statistics.median(walls[1:])
    want_k1 = 2 * (m.cfg.dino.depth + m.cfg.dino.decoder_cfg.num_cross_attn)
    want_k6 = k6_launches_a_match(m.cfg)
    row = {"warp_max_abs_err": werr, "certainty_max_abs_err": cerr, "atol": E2E_ATOL,
           "warp_shape": list(wg.shape), "cpu_match_s": cpu_s, "launches": counts,
           "expected_k1_launches": want_k1, "expected_k6_launches": want_k6, **passes}
    emit("flagship_f32", **row)
    if counts["oneshot_attention"] != want_k1 or counts["refine_block"] != want_k6:
        raise AssertionError(f"float32 flagship: launches {counts}, expected K1 {want_k1}, K6 {want_k6}")
    if not (werr <= E2E_ATOL and cerr <= E2E_ATOL):
        raise AssertionError(f"float32 flagship CUDA vs CPU: warp {werr}, certainty {cerr} > {E2E_ATOL}")
    return row


def accuracy_pairs(torch) -> tuple[dict, float]:
    """The oracle's two sets of synthetic pairs, made on the card: name →
    pairs, and the seconds it took."""
    from gfnet_tpu_torch.eval.synthetic import eval_pairs

    t0 = time.perf_counter()
    sets = [eval_pairs(ACC_PAIRS, ACC_RES, ACC_DEFORMATION, seed=ACC_SEED, cross_modal=cm, device="cuda")
            for cm in (False, True)]
    torch.cuda.synchronize()
    return {p.dataset: p for p in sets}, time.perf_counter() - t0


def accuracy_reading(torch, m, sets: dict, seed: int = 0) -> dict:
    """Each set through `HomographyBenchmark` at batch 4, each pair under its
    key of the serial chain from `PRNGKey(seed)` (seed 0: the JAX reading's
    draws), its results, and the readings the accuracy gate compares: |ACE port - ACE JAX| over the
    pairs the JAX package read (its median and largest per set, its mean over
    the pairs JAX registers below ACC_REGISTERED px of both sets), the MACE of
    those pairs on either side, and the 100-pair MACE against the oracle."""
    import statistics

    from gfnet_tpu_torch.eval.benchmark import HomographyBenchmark

    jax_ref = json.loads(JAX_ACCURACY.read_text())["sets"]
    oracle = json.loads(ORACLE.read_text())
    out = {}
    for name, pairs in sets.items():
        bench = HomographyBenchmark(pairs)
        results = bench.run(m, seed=seed, batch_size=ACC_BATCH, serial_keys=True)
        ref = jax_ref[name]["ace"]
        port = bench.errors[:len(ref)]
        diffs = [abs(a - b) for a, b in zip(port, ref)]
        out[name] = {"results": results, "oracle_mace": oracle[name][f"mace_{name}"],
                     "mace_minus_oracle": results[f"mace_{name}"] - oracle[name][f"mace_{name}"],
                     "jax_pairs": len(ref), "mace_jax_pairs_port": statistics.fmean(port),
                     "mace_jax_pairs_jax": statistics.fmean(ref),
                     "pair_abs_diff_median": statistics.median(diffs), "pair_abs_diff_max": max(diffs),
                     "ace_port_jax": [[p, j] for p, j in zip(port, ref)]}
    registered = [abs(p - j) for r in out.values() for p, j in r["ace_port_jax"] if j < ACC_REGISTERED]
    out["registered_pairs"] = len(registered)
    out["pair_abs_diff_registered_mean"] = statistics.fmean(registered)
    return out


def accuracy_failures(reading: dict) -> list:
    """What the accuracy gate finds wrong with a reading (empty: it passes)."""
    bad = []
    if not reading["pair_abs_diff_registered_mean"] <= ACC_PAIR_TOL:
        bad.append(f"mean |ACE port - ACE JAX| over the {reading['registered_pairs']} registered pairs "
                   f"{reading['pair_abs_diff_registered_mean']} > {ACC_PAIR_TOL}")
    for name, tol in ACC_MACE_TOL.items():
        r = reading[name]
        if not abs(r["mace_minus_oracle"]) <= tol:
            bad.append(f"{name}: MACE {r['results'][f'mace_{name}']} vs the oracle's {r['oracle_mace']} (tol {tol})")
    return bad


def phase_accuracy(torch, m) -> dict:
    """The evaluation path at the flagship width against the JAX package's
    readings and the oracle; returns the launch counts of the run."""
    from gfnet_tpu_torch.ops import kernels

    sets, pair_s = accuracy_pairs(torch)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reading = accuracy_reading(torch, m, sets)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    emit("accuracy", pair_making_s=pair_s, benchmark_s=time.perf_counter() - t0, pairs=ACC_PAIRS,
         batch=ACC_BATCH, keys="JAX serial chain from PRNGKey(0)", launches=counts, pair_tol=ACC_PAIR_TOL,
         pair_abs_diff_registered_mean_torch_draws=ACC_PAIR_TORCH_DRAWS, mace_tol=ACC_MACE_TOL,
         **reading)
    if counts["oneshot_attention"] == 0 or counts["local_corr"] == 0 or counts["local_corr_bwd"] != 0:
        raise AssertionError(f"accuracy: launches {counts}")
    failures = accuracy_failures(reading)
    if failures:
        raise AssertionError("accuracy: " + "; ".join(failures))
    return counts


def data_fixtures(np) -> dict:
    """(a) Every committed fixture decoded by the image library built on this
    machine, against PIL's decode stored beside it; decode times of the
    640×480 4:2:0 JPEG, one thread and a pool."""
    import statistics

    from gfnet_tpu_torch.data import imageio

    built = not any(imageio.BUILD_ROOT.glob(f"imageio_*/{imageio.LIB_NAME}"))
    t0 = time.perf_counter()
    imageio.load_library()
    build_s = time.perf_counter() - t0
    files = sorted(p for p in FIXTURES.iterdir() if p.suffix in (".jpg", ".png"))
    differ = []
    for f in files:
        ref = np.load(f.with_suffix(".npz"))
        same = np.array_equal(imageio.read_image(f), ref["rgb"])
        if "native" in ref.files:
            same = same and np.array_equal(imageio.read_image(f, mode=None).astype(np.int64),
                                           ref["native"].astype(np.int64))
        if not same:
            differ.append(f.name)
    big = FIXTURES / "jpeg_420_640x480.jpg"
    data = big.read_bytes()
    one = []
    for _ in range(20):
        t = time.perf_counter()
        imageio.decode_jpeg(data)
        one.append((time.perf_counter() - t) * 1e3)
    n, threads = 64, 8
    t = time.perf_counter()
    imageio.read_images([big] * n, threads=threads)
    pool_ms = (time.perf_counter() - t) * 1e3 / n
    return {"library_built": built, "library_load_s": build_s, "fixtures": len(files), "fixtures_equal_to_pil": len(files) - len(differ),
            "differ": differ, "jpeg_640x480_420_decode_ms_one_thread": statistics.median(one),
            "jpeg_640x480_420_ms_per_image_pool": pool_ms, "pool_threads": threads, "pool_images": n}


def data_eval_cli(torch, np, m, tmp: Path, vit_pth: Path) -> dict:
    """(b) `tools/make_synth_valdir` writes 16 pairs at 448² on the card;
    `cli.test.main` evaluates the directory at full width; the flagship
    matcher evaluates the same `eval_pairs` in memory under the same keys.
    Then a planted fault: the directory's source images with their channels
    reversed."""
    from gfnet_tpu_torch.cli import test as cli_test
    from gfnet_tpu_torch.data.dataset import HomographyDataset
    from gfnet_tpu_torch.eval.benchmark import HomographyBenchmark
    from gfnet_tpu_torch.eval.synthetic import eval_pairs
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.tools import make_synth_valdir

    t0 = time.perf_counter()
    make_synth_valdir.main(["--n", str(DATA_PAIRS), "--res", str(ACC_RES), "--deformation", str(ACC_DEFORMATION),
                            "--seed", str(ACC_SEED), "--out", str(tmp), "--device", "cuda"])
    write_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli = cli_test.main(["--dataset", "synthetic", "--data_path", str(tmp), "--ckpt_path", str(HEAD_NPZ),
                         "--dinov2_weights", str(vit_pth), "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    pairs = eval_pairs(DATA_PAIRS, ACC_RES, ACC_DEFORMATION, seed=ACC_SEED, device="cuda")
    memory = HomographyBenchmark(pairs).run(m)

    class ChannelsReversed:  # the planted fault
        def __init__(self, ds):
            self.ds, self.dataset = ds, ds.dataset

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            s = dict(self.ds[i])
            s["im_A"] = s["im_A"].flip(-1)
            return s

    val = HomographyDataset("synthetic", "val", str(tmp), (ACC_RES, ACC_RES), device="cuda")
    planted = HomographyBenchmark(ChannelsReversed(val)).run(m)
    key = "mace_synthetic"
    out = {"pairs": DATA_PAIRS, "res": ACC_RES, "write_s": write_s, "cli_s": cli_s,
           "mace_cli": cli[key], "mace_in_memory": memory[key],
           "mace_abs_diff": abs(cli[key] - memory[key]), "tol_px": DATA_MACE_TOL,
           "planted_channels_reversed_abs_diff": abs(planted[key] - memory[key]),
           "cli_results": cli, "launches": counts}
    if counts["oneshot_attention"] == 0 or counts["local_corr"] == 0:
        raise AssertionError(f"data: cli.test launched {counts}")
    return out


def _googlemap_dir(torch, np, root: Path) -> dict:
    """`train/GoogleMap/{map,satellite}/` of DATA_TRAIN_PAIRS pairs of
    DATA_TRAIN_HW textures made on the card (the satellite view a modality
    shift of the map), written as PNG."""
    from gfnet_tpu_torch.data.imageio import write_png
    from gfnet_tpu_torch.eval.synthetic import make_texture, modality_shift, to_uint8

    rng = np.random.default_rng(11)
    h, w = DATA_TRAIN_HW
    for sub in ("map", "satellite"):
        (root / "train" / "GoogleMap" / sub).mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for i in range(DATA_TRAIN_PAIRS):
        tex = make_texture(rng, max(h, w), "cuda")[:h, :w]
        write_png(root / "train" / "GoogleMap" / "map" / f"{i:04d}.png", to_uint8(tex), compress_level=1)
        write_png(root / "train" / "GoogleMap" / "satellite" / f"{i:04d}.png",
                  to_uint8(modality_shift(tex, rng)), compress_level=1)
    return {"pairs": DATA_TRAIN_PAIRS, "hw": [h, w], "write_s": time.perf_counter() - t0}


def data_train_cli(torch, np, tmp: Path, vit_pth: Path) -> dict:
    """(c) `cli.train.main` at full width over a googlemap-layout directory
    (B=8, 64 pairs, the r5b head as the fine-tune start, `--eval_after` on 4
    val pairs), with each step and each batch fetch timed (`train_loop`
    wrapped), the last two steps with their fetches profiled for the card's
    busy share; then the loader alone, its ms per batch."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from gfnet_tpu_torch.cli import train as cli_train
    from gfnet_tpu_torch.data.dataset import BatchLoader, HomographyDataset
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.tools import make_synth_valdir

    made = _googlemap_dir(torch, np, tmp)
    make_synth_valdir.main(["--n", "4", "--res", str(ACC_RES), "--out", str(tmp), "--device", "cuda",
                            "--name", "googlemap_1k_448x448_new"])
    steps, fetch_ms, step_ms, losses = DATA_TRAIN_PAIRS_RUN // TRAIN_BATCH, [], [], []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}
    real_loop = cli_train.train_loop

    def loop(state, step_fn, batches, *args, **kw):
        def fetched():
            it = iter(batches)
            while True:
                if len(fetch_ms) == DATA_PROFILE_FROM:
                    prof.__enter__()
                    window["t0"] = time.perf_counter()
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                torch.cuda.synchronize()
                fetch_ms.append((time.perf_counter() - t) * 1e3)
                yield batch

        def step(state, batch):
            t = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(metrics["total_loss"]))
            if len(step_ms) == steps and "t0" in window:
                window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
                prof.__exit__(None, None, None)
            return state, metrics

        return real_loop(state, step, fetched(), *args, **kw)

    kernels.reset_launch_counts()
    cli_train.train_loop = loop
    t0 = time.perf_counter()
    try:
        cli_train.main(["--dataset", "googlemap", "--data_path", str(tmp), "--workspace", str(tmp / "ws"),
                        "--gpu_batch_size", str(TRAIN_BATCH), "--total_pairs", str(DATA_TRAIN_PAIRS_RUN),
                        "--num_workers", str(DATA_WORKERS), "--dinov2_weights", str(vit_pth), "--ft",
                        "--ft_ckpt", str(HEAD_NPZ), "--device", "cuda", "--log_every", "1",
                        "--eval_after", "--eval_max_pairs", "4"])
    finally:
        cli_train.train_loop = real_loop
    cli_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    evts = device_kernel_events(torch, prof)
    busy_ms = sum(device_us(e) for e in evts) / 1e3

    ds = HomographyDataset("googlemap", "train", str(tmp), (ACC_RES, ACC_RES), device="cuda")
    loader = BatchLoader(ds, TRAIN_BATCH, num_workers=DATA_WORKERS, seed=1)
    alone = []
    try:
        it = loader.batches(DATA_LOADER_BATCHES)
        for _ in range(DATA_LOADER_BATCHES):
            t = time.perf_counter()
            batch = next(it)
            torch.cuda.synchronize()
            alone.append((time.perf_counter() - t) * 1e3)
    finally:
        loader.close()
    read = []
    for i in range(4):
        t = time.perf_counter()
        ds.read(i)
        read.append((time.perf_counter() - t) * 1e3)
    shapes = {k: list(v.shape) for k, v in batch.items()}
    step_med = statistics.median(step_ms[1:DATA_PROFILE_FROM])  # the profiler slows the host
    loader_med = statistics.median(alone[1:])
    out = {"train_dir": made, "cli_s": cli_s, "steps": len(step_ms), "batch": TRAIN_BATCH, "losses": losses,
           "step_ms": step_ms, "step_ms_median": step_med, "fetch_ms_in_loop": fetch_ms,
           "fetch_ms_in_loop_median": statistics.median(fetch_ms[1:DATA_PROFILE_FROM]),
           "loader_ms_per_batch_alone": alone, "loader_ms_median": loader_med,
           "loader_keeps_up": loader_med < step_med, "num_workers": DATA_WORKERS,
           "read_ms_one_pair_one_thread": statistics.median(read), "batch_shapes": shapes,
           "profiled_window": {"from_fetch": DATA_PROFILE_FROM, "wall_ms": window.get("wall_ms"),
                               "device_kernel_ms": busy_ms,
                               "device_busy_share": busy_ms / window["wall_ms"] if window.get("wall_ms") else None},
           "launches": counts}
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"data: cli.train losses {losses} over {steps} steps")
    if min(counts.values()) == 0:
        raise AssertionError(f"data: cli.train launched {counts}")
    return out


def phase_data(torch, np, m, tmp: Path) -> dict:
    """The dataset path of both CLIs on the card: (a) the image fixtures,
    (b) `cli.test` over a PNG val directory against the same pairs in
    memory, (c) `cli.train` over a googlemap-layout directory. The
    directories and `vit.pth` stay in `tmp` for the orbax phase."""
    vit_pth = tmp / "vit.pth"  # the flagship's backbone, so the CLIs need not draw it again
    torch.save(m.vit.state_dict(), vit_pth)
    out = {"nvidia_smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                        capture_output=True, text=True).stdout.strip(),
           "fixtures": data_fixtures(np)}
    out["eval_cli"] = data_eval_cli(torch, np, m, tmp / "eval", vit_pth)
    out["train_cli"] = data_train_cli(torch, np, tmp / "train", vit_pth)
    emit("data", **out)
    fx, ev = out["fixtures"], out["eval_cli"]
    if fx["differ"]:
        raise AssertionError(f"data: fixtures decode unlike PIL: {fx['differ']}")
    if not ev["mace_abs_diff"] <= DATA_MACE_TOL:
        raise AssertionError(f"data: cli.test MACE {ev['mace_cli']} against {ev['mace_in_memory']} in memory")
    if not ev["planted_channels_reversed_abs_diff"] > 10 * DATA_MACE_TOL:
        raise AssertionError(f"data: the planted fault reads {ev['planted_channels_reversed_abs_diff']}")
    return out

def orbax_read(np) -> dict:
    """(a) The reader built on this machine: every leaf of the JAX trainer's
    step directory equal to its `.npz`, and the Orbax flagship head equal to
    `load_head_npz(r5b)`, bit for bit; the head's read rate on one thread."""
    import torch

    from gfnet_tpu_torch.utils import orbax
    from gfnet_tpu_torch.utils.convert import load_head, load_head_npz

    built = not any(orbax.BUILD_ROOT.glob(f"zstd_*/{orbax.LIB_NAME}"))
    t0 = time.perf_counter()
    orbax.load_library()
    build_s = time.perf_counter() - t0
    step_dir = ORBAX_FIXTURES / "tiny_run" / "tinyset" / "step_000000002"
    got = orbax.flatten(orbax.read_checkpoint(step_dir))
    with np.load(ORBAX_FIXTURES / "tiny_run.npz") as raw:
        want = {k[5:]: raw[k] for k in raw.files if k.startswith("leaf/")}
    differ = sorted(k for k in set(got) | set(want)
                    if k not in got or k not in want or got[k].dtype != want[k].dtype
                    or got[k].tobytes() != want[k].tobytes())
    head_dir = ORBAX_FIXTURES / "flagship_head"
    disk = sum(f.stat().st_size for f in head_dir.rglob("*") if f.is_file())
    times = []
    for _ in range(3):
        t = time.perf_counter()
        tree = orbax.read_checkpoint(head_dir)
        times.append(time.perf_counter() - t)
    decoded = sum(v.nbytes for v in orbax.flatten(tree).values())
    sd, kv_norm = load_head(str(head_dir))
    want_sd, _ = load_head_npz(str(HEAD_NPZ))
    head_differ = sorted(k for k in set(sd) | set(want_sd)
                         if k not in sd or k not in want_sd or not torch.equal(sd[k], want_sd[k]))
    best = min(times)
    return {"library_built": built, "library_load_s": build_s, "tiny_run_leaves": len(want),
            "tiny_run_differ": differ, "head_bytes_on_disk": disk, "head_bytes_decoded": decoded,
            "head_read_s": times, "head_read_mb_per_s": disk / best / 1e6,
            "head_kv_norm": kv_norm, "head_tensors": len(want_sd), "head_differ": head_differ}


def _kv_conf(tmp: Path, kv_norm: bool) -> Path:
    """A config JSON of `ModelConfig()` with the decoder's k/v
    standardization as given (the reference schema's defaults fill the rest)."""
    path = tmp / f"flagship_kv_{int(kv_norm)}.json"
    path.write_text(json.dumps({"dino_cfg": {"decoder_cfg": {"kv_norm": kv_norm}}}))
    return path


def orbax_serve(tmp: Path, data: dict) -> dict:
    """(b) `cli.test --ckpt_path <Orbax head>` at full width over the data
    phase's val directory, with `decoder.kv_norm: true` in the config,
    against the data phase's `--ckpt_path r5b.npz` run; then the planted
    fault: the same without k/v standardization."""
    from gfnet_tpu_torch.cli import test as cli_test
    from gfnet_tpu_torch.ops import kernels

    out, key = {}, "mace_synthetic"
    for name, kv in (("kv_norm_conf", True), ("planted_no_kv_norm", False)):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = cli_test.main(["--dataset", "synthetic", "--data_path", str(tmp / "eval"),
                             "--conf_path", str(_kv_conf(tmp, kv)),
                             "--ckpt_path", str(ORBAX_FIXTURES / "flagship_head"),
                             "--dinov2_weights", str(tmp / "vit.pth"), "--device", "cuda"])
        out[name] = {"mace": res[key], "abs_diff_to_npz_run": abs(res[key] - data["eval_cli"]["mace_cli"]),
                     "cli_s": time.perf_counter() - t0, "launches": kernels.launch_counts()}
    out["mace_npz_run"] = data["eval_cli"]["mace_cli"]
    out["tol_px"] = DATA_MACE_TOL
    return out


def orbax_finetune(torch, tmp: Path, data: dict) -> dict:
    """(c) `cli.train --ft --ft_ckpt <Orbax head>` at full width over the
    data phase's googlemap directory (k/v config, B=8, ORBAX_FT_STEPS
    steps): the first loss against the data phase's `--ft_ckpt r5b.npz` run;
    then the planted fault: one step without k/v standardization."""
    from gfnet_tpu_torch.cli import train as cli_train
    from gfnet_tpu_torch.ops import kernels

    real_loop = cli_train.train_loop
    first_npz = data["train_cli"]["losses"][0]

    def run(kv: bool, steps: int) -> dict:
        losses = []

        def loop(state, step_fn, batches, *args, **kw):
            def step(state, batch):
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["total_loss"]))
                return state, metrics

            return real_loop(state, step, batches, *args, **kw)

        kernels.reset_launch_counts()
        cli_train.train_loop = loop
        t0 = time.perf_counter()
        try:
            cli_train.main(["--dataset", "googlemap", "--data_path", str(tmp / "train"),
                            "--workspace", str(tmp / f"ws_orbax_ft_kv{int(kv)}"),
                            "--conf_path", str(_kv_conf(tmp, kv)), "--gpu_batch_size", str(TRAIN_BATCH),
                            "--total_pairs", str(steps * TRAIN_BATCH), "--num_workers", str(DATA_WORKERS),
                            "--dinov2_weights", str(tmp / "vit.pth"),
                            "--ft", "--ft_ckpt", str(ORBAX_FIXTURES / "flagship_head"), "--device", "cuda"])
        finally:
            cli_train.train_loop = real_loop
        return {"losses": losses, "first_loss_rel_diff": abs(losses[0] - first_npz) / abs(first_npz)
                if losses else None, "cli_s": time.perf_counter() - t0, "launches": kernels.launch_counts()}

    return {**run(True, ORBAX_FT_STEPS), "first_loss_npz_run": first_npz, "rtol": ORBAX_LOSS_RTOL,
            "planted_no_kv_norm": run(False, 1)}


def orbax_third_update(torch, np, ws: Path, count_offset: int = 0, device: str = "cuda") -> dict:
    """The port's `Checkpointer` restores the JAX trainer's step 2 on the
    card, then takes the fixture's third fed gradient (AdamW's count moved
    by `count_offset`, the planted fault); max |Δ| to JAX's stored parameters."""
    from gfnet_tpu_torch.config import TrainConfig, tiny_test_config
    from gfnet_tpu_torch.models.gfnet import GFNet
    from gfnet_tpu_torch.train.checkpoint import Checkpointer
    from gfnet_tpu_torch.train.state import create_train_state
    from gfnet_tpu_torch.utils.convert import flax_to_torch_head, flax_to_torch_head_moments

    with np.load(ORBAX_FIXTURES / "tiny_run.npz") as f:
        raw = {k: f[k] for k in f.files}

    def sub(prefix: str) -> dict:
        tree: dict = {}
        for k, v in raw.items():
            if k.startswith(prefix):
                d = tree
                *parents, leaf = k[len(prefix):].split("/")
                for p in parents:
                    d = d.setdefault(p, {})
                d[leaf] = v
        return tree

    cfg = TrainConfig(**{k: raw[f"config/{k}"].item()
                         for k in ("total_pairs", "ckpt_every_pairs", "grad_clip_norm")})
    head = GFNet(tiny_test_config(), dtype=torch.float32).to(device)
    state = create_train_state(head, cfg, int(raw["config/global_batch"]))
    Checkpointer(str(ws), "tinyset").restore(state)
    step = state.step
    for s in state.optimizer.state.values():
        s["step"] += count_offset
    stats = sub("leaf/batch_stats/")
    grads = flax_to_torch_head_moments(sub("grad3/"), stats)
    for name, p in head.named_parameters():
        p.grad = grads[name].to(device)
    state.apply_gradients()
    want = flax_to_torch_head({"params": sub("params3/"), "batch_stats": stats})
    got = head.state_dict()
    diff = max(float((got[n].cpu() - want[n]).abs().max()) for n, _ in head.named_parameters())
    return {"restored_step": step, "max_abs_diff": diff}


def orbax_resume(torch, np, tmp: Path) -> dict:
    """(d) The JAX trainer's step directory resumed on the card: the restore,
    the third update against JAX's (and the planted count fault), then
    `cli.train --tiny` auto-resuming it."""
    import contextlib
    import io
    import shutil

    from gfnet_tpu_torch.cli import train as cli_train
    from gfnet_tpu_torch.config import tiny_test_config

    ws = tmp / "ws_jax_run"
    shutil.copytree(ORBAX_FIXTURES / "tiny_run", ws)
    sound = orbax_third_update(torch, np, ws)
    planted = orbax_third_update(torch, np, ws, count_offset=1)
    rng = np.random.default_rng(5)
    res = tiny_test_config().initial_res[0]
    batches = [synth_batch(torch, np, rng, TRAIN_BATCH, res) for _ in range(4)]
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        state = cli_train.main(["--tiny", "--workspace", str(ws), "--dataset", "tinyset",
                                "--gpu_batch_size", str(TRAIN_BATCH), "--total_pairs", "48",
                                "--ckpt_every", "24", "--dinov2_weights", str(tmp / "absent.pth"),
                                "--device", "cuda", "--log_every", "1000"], batches=batches)
    files = sorted(os.listdir(ws / "tinyset"))
    return {"third_update": sound, "planted_count_plus_one": planted, "atol": ORBAX_RESUME_ATOL,
            "cli_resumed_line": [l for l in printed.getvalue().splitlines() if "auto-resumed" in l],
            "cli_final_step": state.step, "cli_s": time.perf_counter() - t0, "workspace_files": files}


def phase_orbax(torch, np, tmp: Path, data: dict) -> dict:
    """The JAX package's Orbax checkpoints in the port, on this machine:
    (a) read, (b) an Orbax head served by `cli.test` at full width, (c)
    fine-tuned from by `cli.train`, (d) a JAX run resumed."""
    out = {"nvidia_smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                        capture_output=True, text=True).stdout.strip(),
           "read": orbax_read(np)}
    out["serve"] = orbax_serve(tmp, data)
    out["finetune"] = orbax_finetune(torch, tmp, data)
    out["resume"] = orbax_resume(torch, np, tmp)
    emit("orbax", **out)
    rd, sv, ft, rs = out["read"], out["serve"], out["finetune"], out["resume"]
    if rd["tiny_run_differ"] or rd["head_differ"] or rd["head_kv_norm"] is not None:
        raise AssertionError(f"orbax: read differs: {rd['tiny_run_differ'][:5]} {rd['head_differ'][:5]}")
    if not sv["kv_norm_conf"]["abs_diff_to_npz_run"] <= DATA_MACE_TOL:
        raise AssertionError(f"orbax: cli.test MACE {sv['kv_norm_conf']['mace']} against the .npz run's "
                             f"{sv['mace_npz_run']}")
    if not sv["planted_no_kv_norm"]["abs_diff_to_npz_run"] > ORBAX_KV_FAULT_FACTOR * DATA_MACE_TOL:
        raise AssertionError(f"orbax: the planted k/v fault reads {sv['planted_no_kv_norm']}")
    if min(sv["kv_norm_conf"]["launches"][k] for k in ("oneshot_attention", "local_corr")) == 0:
        raise AssertionError(f"orbax: cli.test launched {sv['kv_norm_conf']['launches']}")
    if len(ft["losses"]) != ORBAX_FT_STEPS or not ft["first_loss_rel_diff"] <= ORBAX_LOSS_RTOL:
        raise AssertionError(f"orbax: fine-tune losses {ft['losses']} against the .npz start's "
                             f"{ft['first_loss_npz_run']}")
    if min(ft["launches"][k] for k in TRAIN_KERNELS) == 0:
        raise AssertionError(f"orbax: cli.train launched {ft['launches']}")
    planted = ft["planted_no_kv_norm"]["first_loss_rel_diff"]
    if planted is None or not planted > ORBAX_KV_FAULT_FACTOR * ORBAX_LOSS_RTOL:
        raise AssertionError(f"orbax: the planted k/v fault's first loss reads {ft['planted_no_kv_norm']}")
    if rs["third_update"]["restored_step"] != 2 or not rs["third_update"]["max_abs_diff"] <= ORBAX_RESUME_ATOL:
        raise AssertionError(f"orbax: resumed update {rs['third_update']}")
    if not rs["planted_count_plus_one"]["max_abs_diff"] > ORBAX_RESUME_ATOL:
        raise AssertionError(f"orbax: the planted count fault reads {rs['planted_count_plus_one']}")
    if not rs["cli_resumed_line"] or "step 2" not in rs["cli_resumed_line"][0] or rs["cli_final_step"] <= 2:
        raise AssertionError(f"orbax: cli.train did not resume the JAX run: {rs}")
    if "step_000000002" not in rs["workspace_files"] or not any(
            f.endswith(".pt") and int(f[5:14]) > 2 for f in rs["workspace_files"]):
        raise AssertionError(f"orbax: workspace after cli.train: {rs['workspace_files']}")
    return out


def corr_model_flows(torch, run) -> list:
    """How K2 and K3 tile the flows the model itself hands them: `run()` is
    called with `kernels.local_corr` and `kernels.local_corr_bwd` wrapped so
    that each launch first records its shapes, its tiling and the share of
    its tiles that staged (`corr_tiling`), then launches as usual."""
    from gfnet_tpu_torch.ops import kernels

    real = {"local_corr": kernels.local_corr, "local_corr_bwd": kernels.local_corr_bwd}
    seen: list = []

    def recording(name):
        def launch(first, target, flow, radius, **kw):
            tiling = corr_tiling(torch, flow, target, radius, name == "local_corr")
            seen.append({"kernel": name, "radius": radius, "grid": list(flow.shape[:3]),
                         "target": list(target.shape), "dtype": str(target.dtype).split(".")[-1],
                         **{k: tiling[k] for k in ("tile", "box", "staged_share")}})
            return real[name](first, target, flow, radius, **kw)
        return launch

    try:
        for name in real:
            setattr(kernels, name, recording(name))
        run()
    finally:
        for name, fn in real.items():
            setattr(kernels, name, fn)
    return seen


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def device_kernel_events(torch, prof) -> list:
    """The profile's device-side events with time on the card, without the
    ranges that span other kernels (`Optimizer.step#...`), which would count
    their kernels twice."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]


def own_kernels_ms(evts) -> dict:
    """Device ms of the port's own kernels in a profile: K1, K2, K3."""
    return {n: sum(device_us(e) for e in evts if n in e.key) / 1e3
            for n in ("oneshot_attention", "local_corr_kernel", "local_corr_bwd_kernel")}


def phase_split(torch, m, x, y) -> dict:
    """Each phase of `estimate_homography_batched` (pass 1, pass 2, sample +
    solve) on its own: wall time (median of 5, host clock, synchronized),
    then one run under `torch.profiler` for its kernels' device time. The
    busy share is device time over wall time. One JSON line per phase.
    `sample_solve` includes the JAX-key draws on the card (`_pair_draws`);
    `draw` times them alone and `sample_solve_given_draws` the rest, as
    earlier runs timed sample + solve."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from gfnet_tpu_torch.utils import jax_init

    bsz, hw = x.shape[0], tuple(x.shape[1:3])
    keys = jax_init.split(jax_init.prng_key(0), bsz)
    out = {}
    with torch.inference_mode():
        pre = m._pass1(x, y)
        warp, cert = m._pass2(x, y, *pre)
        n = cert[0].numel()
        draws = m._pair_draws(keys, n, 5000)
        for name, fn in (("pass1", lambda: m._pass1(x, y)),
                         ("pass2", lambda: m._pass2(x, y, *pre)),
                         ("sample_solve", lambda: m._sample_solve(warp, cert, 5000, hw, hw,
                                                                  m._pair_draws(keys, n, 5000))),
                         ("draw", lambda: m._pair_draws(keys, n, 5000)),
                         ("sample_solve_given_draws", lambda: m._sample_solve(warp, cert, 5000, hw, hw, draws))):
            fn()
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            evts = device_kernel_events(torch, prof)
            kernel_ms = sum(device_us(e) for e in evts) / 1e3
            wall = statistics.median(walls)
            top = sorted(evts, key=device_us, reverse=True)[:8]
            out[name] = {"wall_ms": wall, "wall_ms_runs": walls, "device_kernel_ms": kernel_ms,
                         "device_busy_share": kernel_ms / wall,
                         "kernel_launches": sum(e.count for e in evts),
                         "own_kernels_ms": own_kernels_ms(evts),
                         "top_kernels": [{"name": e.key[:90], "ms": device_us(e) / 1e3,
                                          "count": e.count} for e in top]}
            emit("flagship_split", batch=bsz, part=name, **out[name])
    return out


# (radius, C, target side, grid side) of every refiner with r > 0 in the train
# step at 448², B = 8 pairs (symmetric=False)
TRAIN_CORR_SHAPES = [(7, 64, 32, 32), (6, 64, 56, 32), (4, 32, 112, 64), (2, 16, 224, 128)]
TRAIN_BATCH = 8


def phase_k3(torch, against=None) -> dict:
    """K3 against `local_corr_dq_plain` at the train step's shapes (B=8,
    float32, and one bf16 target), and K2 at the same float32 shapes (phase 4
    covers the inference shapes in bf16), each on the homography and the
    random flow; then the branch cases, two K3 launches that must agree bit
    for bit, and the zero windows. `against` as in `phase_k2`. Returns K3's
    summary row."""
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.ops.local_correlation import (_local_correlation_patch, local_corr_dq_plain,
                                                       local_corr_dq_tiled_plain, local_corr_tiled_plain)
    from gfnet_tpu_torch.utils.profiling import PEAK_F32_FLOPS, bound

    gen = torch.Generator("cuda").manual_seed(7)
    rows, k2_rows = [], []
    shapes = [(*shape, torch.float32) for shape in TRAIN_CORR_SHAPES] + [(6, 64, 56, 32, torch.bfloat16)]
    cases = [(shape, kind) for shape in shapes for kind in CORR_TIMED_FLOWS]
    cases += [((6, 64, 56, 32, torch.float32), kind) for kind in ("staged_only", "mixed")]
    for i, ((r, c, t, g, tdt), kind) in enumerate(cases):
        b, taps = TRAIN_BATCH, (2 * r + 1) ** 2
        query = torch.randn((b, g, g, c), generator=gen, device="cuda")
        target = torch.randn((b, t, t, c), generator=gen, device="cuda").to(tdt)
        flow = corr_flow(torch, kind, b, g, t, 70 + i)
        grad = torch.randn((b, g, g, taps), generator=gen, device="cuda")
        active = k2_active_cells(torch, flow, t, t, r)
        got = kernels.local_corr_bwd(grad, target, flow, r)
        want = local_corr_dq_plain(grad, target, flow, r)
        again = kernels.local_corr_bwd(grad, target, flow, r)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        repeatable = bool(torch.equal(got, again))

        def autograd_plain():
            q = query.detach().requires_grad_()
            _local_correlation_patch(q, target.float(), flow, r).backward(grad)

        elem = target.element_size()
        tiling = corr_tiling(torch, flow, target, r, False)
        row = {"radius": r, "grad": [b, g, g, taps], "target": [b, t, t, c],
               "target_dtype": str(tdt).split(".")[-1], "flow": kind, "max_abs_err": err,
               "atol": K3_ATOL, "bitwise_repeatable": repeatable}
        fns = {"kernel": lambda: kernels.local_corr_bwd(grad, target, flow, r),
               "earlier": against and (lambda: against.local_corr_bwd(grad, target, flow, r))}
        if kind == "homography":
            off = unstaged_schedule(r, c, elem, kernels.corr_schedule(r, c, elem, t, t, g, g, b, False), False)
            fns["unstaged"] = lambda: kernels.local_corr_bwd(grad, target, flow, r, off)
            row["unstaged_max_abs_err"] = (fns["unstaged"]() - want).abs().max().item()
            row["unstaged_staged_share"] = corr_tiling(torch, flow, target, r, False, off)["staged_share"]
            err = max(err, row["unstaged_max_abs_err"])
        row.update(timed_in_turns(torch, fns, 20))
        row.update(plain_ms=cuda_ms(torch, lambda: local_corr_dq_plain(grad, target, flow, r), 3),
                   autograd_plain_ms=cuda_ms(torch, autograd_plain, 3), library_ms=None, active_cells=active)
        if kind in ("staged_only", "mixed"):
            tile, box = tiling["tile"], tiling["box"]
            row["max_abs_err_vs_tiled"] = (got - local_corr_dq_tiled_plain(grad, target, flow, r, tile, box)
                                           ).abs().max().item()
            err = max(err, row["max_abs_err_vs_tiled"])
        # float32 gradient × float32 or bf16 target: float32 products; bytes:
        # grad, target, flow read once, dq written once
        nbytes = 4 * (grad.numel() + flow.numel() + got.numel()) + elem * target.numel()
        row["bound_ms"], row["bound_by"] = bound(corr_ops(active, r, c, PEAK_F32_FLOPS), nbytes)
        row.update(tiling)
        emit("k3", **row)
        if not err <= K3_ATOL:
            raise AssertionError(f"K3 r={r} t={t} g={g} {tdt} {kind} flow: max abs err {err} > {K3_ATOL}")
        if not repeatable:
            raise AssertionError(f"K3 r={r} t={t} g={g} {kind} flow: two launches differ")
        rows.append(row)
        if tdt != torch.float32:
            continue
        out = kernels.local_corr(query, target, flow, r)
        want2 = _local_correlation_patch(query, target, flow, r)
        err2 = (out - want2).abs().max().item()
        row2 = {"radius": r, "query": [b, g, g, c], "target": [b, t, t, c], "dtype": "float32",
                "flow": kind, "max_abs_err": err2, "atol": K2_ATOL}
        tiling2 = corr_tiling(torch, flow, target, r, True)
        fns = {"kernel": lambda: kernels.local_corr(query, target, flow, r),
               "earlier": against and (lambda: against.local_corr(query, target, flow, r))}
        if kind == "homography":
            off2 = unstaged_schedule(r, c, 4, kernels.corr_schedule(r, c, 4, t, t, g, g, b, True), True)
            fns["unstaged"] = lambda: kernels.local_corr(query, target, flow, r, off2)
            row2["unstaged_max_abs_err"] = (fns["unstaged"]() - want2).abs().max().item()
            row2["unstaged_staged_share"] = corr_tiling(torch, flow, target, r, True, off2)["staged_share"]
            err2 = max(err2, row2["unstaged_max_abs_err"])
        row2.update(timed_in_turns(torch, fns, 20))
        row2.update(plain_ms=cuda_ms(torch, lambda: _local_correlation_patch(query, target, flow, r), 3),
                    library_ms=None, active_cells=active)
        if kind in ("staged_only", "mixed"):
            tiled = local_corr_tiled_plain(query, target, flow, r, tiling2["tile"], tiling2["box"])
            row2["max_abs_err_vs_tiled"] = (out - tiled).abs().max().item()
            err2 = max(err2, row2["max_abs_err_vs_tiled"])
        nbytes2 = 4 * (query.numel() + target.numel() + flow.numel() + out.numel())
        row2["bound_ms"], row2["bound_by"] = bound(corr_ops(active, r, c, PEAK_F32_FLOPS), nbytes2)
        row2.update(tiling2)
        emit("k2_train", **row2)
        if not err2 <= K2_ATOL:
            raise AssertionError(f"K2 float32 r={r} t={t} g={g} {kind} flow: max abs err {err2} > {K2_ATOL}")
        k2_rows.append(row2)
    check_corr_branches("K3", rows)
    check_corr_branches("K2 float32", k2_rows)
    for name, value in (("far_out_of_range", 5.0), ("nan", math.nan)):
        grad = torch.randn((2, 32, 32, 225), generator=gen, device="cuda")
        target = torch.randn((2, 32, 32, 64), generator=gen, device="cuda")
        flow = torch.full((2, 32, 32, 2), value, device="cuda")
        zeros = bool((kernels.local_corr_bwd(grad, target, flow, 7) == 0).all().item())
        emit("k3_zero_window", case=name, all_zero=zeros)
        if not zeros:
            raise AssertionError(f"K3 {name} flow did not give an all-zero gradient")
    corr_host_cost(torch, "k3_host_us_per_launch", kernels.local_corr_bwd, against and against.local_corr_bwd,
                   (6, 64, 56, 32, TRAIN_BATCH, torch.float32))
    return summary_row(rows)


def synth_batch(torch, np, rng, b: int, res: int) -> dict:
    """A training batch made on the card: seeded smooth images as view A,
    a seeded four-point homography per pair (corners moved by up to 15% of
    the side), view B = view A warped by it, both shipped as uint8 with
    H_s2t in the corner-aligned pixel convention the loss expects."""
    from gfnet_tpu_torch.core.geometry import get_perspective_transform, warp_perspective

    im_a = torch.from_numpy(smooth_images(np, rng, b, res, res)).cuda()
    side = res - 1.0
    corners = np.array([[0, 0], [side, 0], [side, side], [0, side]], np.float32)
    moved = corners + rng.uniform(-0.15 * res, 0.15 * res, (b, 4, 2)).astype(np.float32)
    H = get_perspective_transform(torch.from_numpy(np.broadcast_to(corners, (b, 4, 2)).copy()).cuda(),
                                  torch.from_numpy(moved).cuda())
    im_b = warp_perspective(im_a, H, (res, res), align_corners=True)
    to_u8 = lambda t: (t.clamp(0, 1) * 255.0 + 0.5).to(torch.uint8)
    return {"im_A": to_u8(im_a), "im_B": to_u8(im_b), "H_s2t": H}


def tiny_train_compare(torch, np) -> dict:
    """One train step of the tiny config (trained tiny head) on CUDA against
    the CPU on the same batch: the loss and every head gradient. The clip is
    set out of reach, so `.grad` holds the raw gradients after the step."""
    from gfnet_tpu_torch.config import TrainConfig
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.train.loss import RobustLoss
    from gfnet_tpu_torch.train.state import create_train_state
    from gfnet_tpu_torch.train.step import make_train_step

    gpu, cpu, _, _ = tiny_setup(torch, np)
    res = gpu.cfg.initial_res[0]
    batch = {k: v.cpu() for k, v in synth_batch(torch, np, np.random.default_rng(8), 4, res).items()}
    tcfg = TrainConfig(grad_clip_norm=1e30)
    out = {}
    for name, m in (("cuda", gpu), ("cpu", cpu)):
        state = create_train_state(m.head, tcfg, 4)
        kernels.reset_launch_counts()
        _, metrics = make_train_step(m, RobustLoss(im_size=res))(state, batch)
        out[name] = (float(metrics["total_loss"]), kernels.launch_counts(),
                     {k: p.grad.detach().cpu() for k, p in m.head.named_parameters()})
    (loss_g, counts, grads_g), (loss_c, counts_cpu, grads_c) = out["cuda"], out["cpu"]
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    # each leaf against the largest gradient entry of its top-level module: a
    # bias in front of a train-mode BatchNorm has a zero gradient, so its own
    # size is rounding noise and no scale to measure by
    top = lambda k: ".".join(k.split(".")[:2 if k.startswith("conv_refiner") else 1])
    scale: dict = {}
    for k, g in grads_c.items():
        scale[top(k)] = max(scale.get(top(k), 0.0), g.abs().max().item())
    rel = {k: (grads_g[k] - grads_c[k]).abs().max().item() / scale[top(k)] for k in grads_c}
    worst = max(rel, key=rel.get)
    return {"loss_cuda": loss_g, "loss_cpu": loss_c, "loss_rel_err": loss_rel,
            "loss_rtol": TINY_LOSS_RTOL, "grad_leaves": len(rel), "grad_max_rel_err": rel[worst],
            "grad_worst_leaf": worst, "grad_rtol": TINY_GRAD_RTOL,
            "grad_worst_leaves": {k: rel[k] for k in sorted(rel, key=rel.get, reverse=True)[:5]},
            "launches": counts, "launches_cpu": counts_cpu}


def phase_tiny_grads(torch, np) -> None:
    r = tiny_train_compare(torch, np)
    emit("tiny_train_cuda_vs_cpu", **r)
    if min(r["launches"][k] for k in TRAIN_KERNELS) == 0 or any(r["launches_cpu"].values()):
        raise AssertionError(f"tiny train step: launches on CUDA {r['launches']}, on the CPU {r['launches_cpu']}")
    if not (math.isfinite(r["loss_cuda"]) and r["loss_rel_err"] <= TINY_LOSS_RTOL
            and r["grad_max_rel_err"] <= TINY_GRAD_RTOL):
        raise AssertionError(f"tiny train step CUDA vs CPU: loss rel {r['loss_rel_err']}, "
                             f"grad rel {r['grad_max_rel_err']} at {r['grad_worst_leaf']}")


def phase_trainer(torch, np, m) -> dict:
    """The trainer at the flagship width: `cli.train.train_loop` over a
    synthetic stream, B=8 at 448², bf16, head from the trained flagship
    weights, the flagship fine-tune recipe (lr_per_sample 1.25e-4, clip 0.1)."""
    import statistics
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from gfnet_tpu_torch.cli.train import train_loop
    from gfnet_tpu_torch.config import TrainConfig
    from gfnet_tpu_torch.models.gfnet import GFNet
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.train.checkpoint import Checkpointer
    from gfnet_tpu_torch.train.loss import RobustLoss
    from gfnet_tpu_torch.train.state import create_train_state
    from gfnet_tpu_torch.train.step import make_train_step
    from gfnet_tpu_torch.utils.convert import jax_head_state

    cfg, b, res = m.cfg, TRAIN_BATCH, m.cfg.initial_res[0]
    steps, chunk = 5, 2
    tcfg = TrainConfig(total_pairs=steps * b, ckpt_every_pairs=chunk * b, per_host_batch_size=b,
                       lr_per_sample=1.25e-4, grad_clip_norm=0.1)
    state = create_train_state(m.head, tcfg, b)
    step_fn = make_train_step(m, RobustLoss(im_size=res))
    with_grad = sum(r > 0 for r in cfg.matcher.radius)
    cross = cfg.dino.decoder_cfg.num_cross_attn
    # the feature extraction and each refiner run twice (recomputed in backward)
    want = {"oneshot_attention": cfg.dino.depth + 2 * cross, "local_corr": 2 * with_grad,
            "local_corr_bwd": with_grad, "kde": 0, "residual_norm": 3 * cfg.dino.depth + 1, "refine_block": 0}
    before = {k: v.detach().clone() for k, v in m.head.state_dict().items()}
    rng = np.random.default_rng(9)
    log: list = []

    def timed_step(state, batch):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        log.append({"step": state.step, "wall_ms": (time.perf_counter() - t0) * 1e3,
                    "launches": kernels.launch_counts(),
                    **{k: float(v) for k, v in metrics.items()}})
        emit("train_step", **log[-1])
        return state, metrics

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(tmp, "smoke")
        train_loop(state, timed_step, (synth_batch(torch, np, rng, b, res) for _ in range(steps)),
                   ckpt, steps, chunk, b)
        saved = sorted(Path(ckpt.dir).iterdir())
        fresh = GFNet(cfg, dtype=m.dtype)
        fresh.load_state_dict(jax_head_state(cfg, 1))
        fresh = fresh.to(m.device)
        restored = Checkpointer(tmp, "smoke").restore(create_train_state(fresh, tcfg, b))
    peak = torch.cuda.max_memory_allocated()

    now = m.head.state_dict()
    same = (restored is not None and restored.step == state.step
            and all(torch.equal(v, restored.head.state_dict()[k]) for k, v in now.items())
            and all(torch.equal(a[key], bb[key])
                    for a, bb in zip(state.optimizer.state_dict()["state"].values(),
                                     restored.optimizer.state_dict()["state"].values())
                    for key in ("exp_avg", "exp_avg_sq")))
    moved_params = sum(not torch.equal(p.detach(), before[k]) for k, p in m.head.named_parameters())
    moved_stats = sum(not torch.equal(v, before[k]) for k, v in m.head.named_buffers())
    losses = [r["total_loss"] for r in log]
    counts_ok = all(r["launches"] == want for r in log)
    walls = [r["wall_ms"] for r in log[1:]]  # the first step warms up cuDNN and the allocator

    batch = synth_batch(torch, np, rng, b, res)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    evts = device_kernel_events(torch, prof)
    kernel_ms = sum(device_us(e) for e in evts) / 1e3
    top = sorted(evts, key=device_us, reverse=True)[:12]
    ours = own_kernels_ms(evts)
    batch = synth_batch(torch, np, rng, b, res)
    emit("corr_model_flows", path="train_step", batch=b,
         launches=corr_model_flows(torch, lambda: step_fn(state, batch)))
    result = {"steps": len(log), "batch": b, "res": res, "step_ms_median": statistics.median(walls),
              "step_ms_runs": walls, "pairs_per_s": b / (statistics.median(walls) / 1e3),
              "max_memory_allocated": peak, "losses": losses, "launches_per_step": log[-1]["launches"],
              "expected_launches": want, "checkpoints": [f.name for f in saved],
              "restore_equal": bool(same), "params_moved": moved_params, "stats_moved": moved_stats,
              "profiled_step": {"wall_ms": prof_wall, "device_kernel_ms": kernel_ms,
                                "device_busy_share": kernel_ms / prof_wall,
                                # the profiler slows the host; against the unprofiled step:
                                "device_ms_over_median_step": kernel_ms / statistics.median(walls),
                                "kernel_launches": sum(e.count for e in evts),
                                "own_kernels_ms": ours,
                                "top_kernels": [{"name": e.key[:90], "ms": device_us(e) / 1e3,
                                                 "count": e.count} for e in top]}}
    emit("trainer", **result)
    if len(log) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"trainer: {len(log)} steps, losses {losses}")
    if any(r["nonfinite_grad_leaves"] != 0 for r in log):
        raise AssertionError("trainer: non-finite gradient leaves")
    if not counts_ok:
        raise AssertionError(f"trainer: launches per step {[r['launches'] for r in log]}, expected {want}")
    if not same:
        raise AssertionError("trainer: the restored checkpoint differs from the state that was saved")
    if moved_params == 0 or moved_stats == 0:
        raise AssertionError("trainer: parameters or running statistics did not move")
    return result


def phase_learn(torch) -> dict:
    """The port learns on the card: `eval/learnability.run` (tiny config,
    the JAX package's seed-0 draw, 500 steps of 8 pairs made on the card,
    then 16 held-out pairs at 2000 matches), gated on the MACE before and
    after, beside the JAX script's CPU readings."""
    from gfnet_tpu_torch.eval.learnability import run
    from gfnet_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    r = run(device="cuda")
    counts = kernels.launch_counts()
    row = {k: v for k, v in r.items() if k != "errors_random"}
    emit("learn", **row, launches=counts, jax=LEARN_JAX,
         gate={"mace_random_min": LEARN_RANDOM_MIN, "mace_trained_max": LEARN_TRAINED_MAX})
    if min(counts.values()) == 0:
        raise AssertionError(f"learn: launches {counts}")
    if not (r["mace_random"] >= LEARN_RANDOM_MIN and r["mace_trained"] <= LEARN_TRAINED_MAX):
        raise AssertionError(f"learn: MACE {r['mace_random']} random, {r['mace_trained']} trained "
                             f"(gate >= {LEARN_RANDOM_MIN}, <= {LEARN_TRAINED_MAX})")
    return r


def phase_ops_extra(torch) -> dict:
    """The ops off the main path that reach the card:
    `local_correlation_multilevel` at r = 4 over 3 levels in bf16 on pass
    1's r = 4 shape (K2 at each level of the pooled target) against the plain
    version at each level, K2's gate; and `grid_sample` with border padding
    on the card against the CPU, on points out to ±1.6."""
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.ops.local_correlation import (_local_correlation_patch, local_correlation_multilevel,
                                                       target_pyramid)
    from gfnet_tpu_torch.ops.sampler import grid_sample

    gen = torch.Generator("cuda").manual_seed(14)
    r, c, t, g, levels = 4, 32, 112, 64, 3
    query = torch.randn((2, g, g, c), generator=gen, device="cuda").to(torch.bfloat16)
    target = torch.randn((2, t, t, c), generator=gen, device="cuda").to(torch.bfloat16)
    flow = corr_flow(torch, "homography", 2, g, t, 15)
    kernels.reset_launch_counts()
    got = local_correlation_multilevel(query, target, flow, r, levels)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = torch.cat([_local_correlation_patch(query, lvl, flow, r) for lvl in target_pyramid(target, levels)], -1)
    err = (got - want).abs().max().item()
    img = torch.randn((2, 40, 50, 8), generator=gen, device="cuda")
    grid = torch.rand((2, 30, 20, 2), generator=gen, device="cuda") * 3.2 - 1.6
    border = grid_sample(img, grid, padding_mode="border")
    gerr = (border.cpu() - grid_sample(img.cpu(), grid.cpu(), padding_mode="border")).abs().max().item()
    row = {"multilevel": {"radius": r, "levels": levels, "query": [2, g, g, c], "target": [2, t, t, c],
                          "dtype": "bfloat16", "out": list(got.shape), "max_abs_err": err, "atol": K2_ATOL,
                          "launches": launches},
           "grid_sample_border": {"img": [2, 40, 50, 8], "points": [2, 30, 20], "max_abs_err_vs_cpu": gerr,
                                  "atol": GRID_SAMPLE_ATOL}}
    emit("ops_extra", **row)
    if launches["local_corr"] != levels:
        raise AssertionError(f"ops_extra: multilevel launched K2 {launches['local_corr']} times, not {levels}")
    if not err <= K2_ATOL:
        raise AssertionError(f"ops_extra: multilevel K2 against plain {err} > {K2_ATOL}")
    if not gerr <= GRID_SAMPLE_ATOL:
        raise AssertionError(f"ops_extra: border grid_sample on the card vs the CPU {gerr} > {GRID_SAMPLE_ATOL}")
    return row


def step_profile(torch, prof, wall_ms: float) -> dict:
    """What one profiled train step spent: its device work, the NCCL
    kernels and the copies among it (NCCL in a world of one copies and
    launches no kernel), the host's calls that wait for the card, and the
    host's time by operator."""
    evts = device_kernel_events(torch, prof)
    nccl = [e for e in evts if "nccl" in e.key.lower()]
    copies = [e for e in evts if "memcpy" in e.key.lower()]
    cpu = {e.key: e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU}
    return {"wall_ms": wall_ms, "device_kernel_ms": sum(device_us(e) for e in evts) / 1e3,
            "kernel_launches": sum(e.count for e in evts),
            "nccl_kernels": sum(e.count for e in nccl), "nccl_device_ms": sum(device_us(e) for e in nccl) / 1e3,
            "copies": {e.key[:80]: {"count": e.count, "ms": device_us(e) / 1e3} for e in copies},
            "host_waits": {k: {"count": e.count, "self_ms": e.self_cpu_time_total / 1e3} for k, e in cpu.items()
                           if "Synchronize" in k or "WaitEvent" in k or k in ("aten::item", "aten::_local_scalar_dense")},
            "host_self_ms": sum(e.self_cpu_time_total for e in cpu.values()) / 1e3,
            "host_ops": {k: (e.count, e.self_cpu_time_total / 1e3) for k, e in cpu.items()}}


def phase_dist(torch, np, m) -> dict:
    """The multi-device path over NCCL in a world of one: the flagship train
    step through `make_train_step(mesh=...)`, and with the frozen ViT
    sharded (`fsdp_vit=True`), against the same step without a mesh from
    the same weights (loss and every gradient, phase 8's gates), the three
    timed in turns; one step with and one without the mesh profiled
    (`utils/profiling.trace`: NCCL kernels, device and host time by
    operator); `shard_for_mesh` serving at B=8, with the ViT whole and
    sharded, against the unsharded matcher under one key; the ViT's
    resident bytes and all-gathers; and `corr_volume_flow_sharded` against
    the dense version. A process group that does not come up over NCCL
    fails the phase."""
    import copy
    import socket
    import statistics
    import tempfile

    import torch.distributed as dist

    from gfnet_tpu_torch.config import TrainConfig
    from gfnet_tpu_torch.core.homography import corner_error
    from gfnet_tpu_torch.ops import kernels
    from gfnet_tpu_torch.ops.correlation import corr_volume_flow, corr_volume_flow_sharded
    from gfnet_tpu_torch.parallel import Mesh, fsdp_param_sharding, init_distributed
    from gfnet_tpu_torch.train.loss import RobustLoss
    from gfnet_tpu_torch.train.state import create_train_state
    from gfnet_tpu_torch.train.step import make_train_step
    from gfnet_tpu_torch.utils import jax_init
    from gfnet_tpu_torch.utils.profiling import trace

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh = init_distributed("cuda", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"dist: process group on {backend}, not NCCL")
        mesh.all_reduce_(torch.zeros(1, device=mesh.device))  # NCCL sets up its communicator here
        b, res = TRAIN_BATCH, m.cfg.initial_res[0]
        batch = synth_batch(torch, np, np.random.default_rng(10), b, res)
        saved = {k: v.detach().clone() for k, v in m.head.state_dict().items()}
        vit_bytes = lambda vit: sum(p.numel() * p.element_size() for p in vit.parameters())
        # the FSDP step shards its matcher's ViT in place: a copy, so that the
        # other runs keep the whole one
        fm = copy.copy(m)
        fm.vit = copy.deepcopy(m.vit)
        bytes_whole = vit_bytes(fm.vit)
        spec = fsdp_param_sharding(mesh, fm.vit)
        split_bytes = sum(p.numel() * p.element_size() for k, p in fm.vit.named_parameters() if spec[k] is not None)
        variants = {"no_mesh": (None, m, False), "mesh": (mesh, m, False), "mesh_fsdp": (mesh, fm, True)}

        def step_fn_of(name):
            """A fresh state from the saved weights and the step of `name`."""
            on, matcher, fsdp = variants[name]
            m.head.load_state_dict(saved)  # `fm` shares the head
            state = create_train_state(m.head, TrainConfig(grad_clip_norm=1e30), b)
            return state, make_train_step(matcher, RobustLoss(im_size=res), on, fsdp_vit=fsdp)

        def one_step(name):
            """One step from the saved weights: (metrics, ms until the card
            is done, ms until the step returned to the host)."""
            state, step_fn = step_fn_of(name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = step_fn(state, batch)
            returned = time.perf_counter()
            torch.cuda.synchronize()
            return metrics, (time.perf_counter() - t0) * 1e3, (returned - t0) * 1e3

        runs = {}
        for name in variants:
            kernels.reset_launch_counts()
            gathers = fm.vit.fsdp.gathers if hasattr(fm.vit, "fsdp") else 0
            metrics = one_step(name)[0]
            runs[name] = {"loss": float(metrics["total_loss"]), "launches": kernels.launch_counts(),
                          "grads": {k: p.grad.detach().float().clone() for k, p in m.head.named_parameters()}}
            if name == "mesh_fsdp":
                runs[name]["gathers"] = fm.vit.fsdp.gathers - gathers
        bytes_fsdp = vit_bytes(fm.vit)
        ms = {name: [] for name in variants}
        host_ms = {name: [] for name in variants}
        for _ in range(DIST_STEP_REPEATS):  # in turns, after the first step of each
            for name in variants:
                _, done, returned = one_step(name)
                ms[name].append(done)
                host_ms[name].append(returned)

        profiled = {}
        with tempfile.TemporaryDirectory() as tmp:
            for name in ("no_mesh", "mesh"):
                state, step_fn = step_fn_of(name)
                torch.cuda.synchronize()
                with trace(os.path.join(tmp, name)) as prof:
                    t0 = time.perf_counter()
                    step_fn(state, batch)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                profiled[name] = step_profile(torch, prof, wall)
                profiled[name]["trace_bytes"] = os.path.getsize(os.path.join(tmp, name, "trace.json"))
        m.head.load_state_dict(saved)
        m.head.requires_grad_(False)

        ref = runs["no_mesh"]
        top = lambda k: ".".join(k.split(".")[:2 if k.startswith("conv_refiner") else 1])
        scale: dict = {}
        for k, g in ref["grads"].items():
            scale[top(k)] = max(scale.get(top(k), 0.0), g.abs().max().item())
        steps = {}
        for name in ("mesh", "mesh_fsdp"):
            got = runs[name]
            rel = {k: (got["grads"][k] - g).abs().max().item() / scale[top(k)] for k, g in ref["grads"].items()}
            worst = max(rel, key=rel.get)
            steps[name] = {"loss": got["loss"], "loss_no_mesh": ref["loss"],
                           "loss_rel_err": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                           "loss_rtol": TINY_LOSS_RTOL, "grad_leaves": len(rel), "grad_max_rel_err": rel[worst],
                           "grad_worst_leaf": worst, "grad_rtol": TINY_GRAD_RTOL, "launches": got["launches"]}
        steps["mesh_fsdp"]["vit_all_gathers_per_step"] = runs["mesh_fsdp"]["gathers"]
        step_ms = {f"ms_{name}": ms[name] for name in variants}
        step_ms.update({f"ms_{name}_median": statistics.median(ms[name]) for name in variants})
        # the host's share: when the step returned, before the card finished
        step_ms.update({f"host_ms_{name}_median": statistics.median(host_ms[name]) for name in variants})
        extra = {"wall_ms": profiled["mesh"]["wall_ms"] - profiled["no_mesh"]["wall_ms"],
                 "device_kernel_ms": profiled["mesh"]["device_kernel_ms"] - profiled["no_mesh"]["device_kernel_ms"],
                 "host_self_ms": profiled["mesh"]["host_self_ms"] - profiled["no_mesh"]["host_self_ms"]}
        ops_m, ops_n = profiled["mesh"].pop("host_ops"), profiled["no_mesh"].pop("host_ops")
        grown = {k: (c, t - ops_n.get(k, (0, 0.0))[1], c - ops_n.get(k, (0, 0.0))[0]) for k, (c, t) in ops_m.items()}
        extra["host_ops_grown"] = [{"op": k[:80], "calls": c, "extra_calls": dc, "extra_self_ms": dt}
                                   for k, (c, dt, dc) in sorted(grown.items(), key=lambda kv: -kv[1][1])[:12]]

        imgs = torch.from_numpy(smooth_images(np, np.random.default_rng(12), 16, res, res)).cuda()
        key = jax_init.prng_key(3)
        H_ref = m.estimate_homography_batched(imgs[:8], imgs[8:], key=key)
        serve = {}
        for name, vit in (("whole_vit", m.vit), ("fsdp_vit", fm.vit)):
            sharded = copy.copy(m)
            sharded.vit = vit
            sharded.shard_for_mesh(mesh, fsdp_vit=name == "fsdp_vit")
            gathers = vit.fsdp.gathers if name == "fsdp_vit" else 0
            kernels.reset_launch_counts()
            H_mesh = sharded.estimate_homography_batched(imgs[:8], imgs[8:], key=key)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            ce = [corner_error(H_mesh[i].double(), H_ref[i].double(), res, res).item() for i in range(8)]
            serve[name] = {"batch": 8, "H_max_abs_diff": (H_mesh - H_ref).abs().max().item(),
                           "corner_error_px_max": max(ce), "px_tol": DIST_SERVE_PX, "launches": launches}
            if name == "fsdp_vit":  # two passes a call, each one ViT forward
                serve[name]["vit_all_gathers_per_pass"] = (vit.fsdp.gathers - gathers) / 2

        gen = torch.Generator("cuda").manual_seed(13)
        f0, f1 = (torch.randn((2, 32, 32, 64), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
        dense = corr_volume_flow(f0, f1)
        corr = {"shape": [2, 32, 32, 64],
                "max_abs_err": (corr_volume_flow_sharded(f0, f1, mesh) - dense).abs().max().item(),
                "atol": DIST_CORR_ATOL}
        # what a rank would hold over more ranks, by the same rule (arithmetic, not measured)
        per_rank = {}
        for n in (2, 4):
            spec_n = fsdp_param_sharding(Mesh(n, 0, mesh.device), m.vit)
            per_rank[n] = sum(p.numel() * p.element_size() // (n if spec_n[k] is not None else 1)
                              for k, p in m.vit.named_parameters())
        vit = {"bytes_whole": bytes_whole, "bytes_fsdp_world_of_one": bytes_fsdp, "split_leaves":
               sum(a is not None for a in spec.values()), "leaves": len(spec), "split_leaf_bytes": split_bytes,
               "bytes_a_rank_arithmetic": per_rank}
        out = {"backend": backend, "world_size": mesh.size, "device": str(mesh.device), "train_step": steps,
               "step_ms": step_ms, "mesh_step_profile": profiled, "mesh_step_extra": extra, "vit": vit,
               "serve": serve, "corr": corr}
        emit("dist", **out)
        for name, step in steps.items():
            if not (math.isfinite(step["loss"]) and step["loss_rel_err"] <= TINY_LOSS_RTOL
                    and step["grad_max_rel_err"] <= TINY_GRAD_RTOL):
                raise AssertionError(f"dist {name} train step: loss rel {step['loss_rel_err']}, grad rel "
                                     f"{step['grad_max_rel_err']} at {step['grad_worst_leaf']}")
            if min(step["launches"][k] for k in TRAIN_KERNELS) == 0:
                raise AssertionError(f"dist {name}: launches {step['launches']}")
        if steps["mesh_fsdp"]["vit_all_gathers_per_step"] == 0 or vit["split_leaves"] == 0:
            raise AssertionError(f"dist: the FSDP step gathered nothing ({vit})")
        for name, sv in serve.items():
            if sv["launches"]["oneshot_attention"] == 0:
                raise AssertionError(f"dist serving {name}: launches {sv['launches']}")
            if not sv["corner_error_px_max"] <= DIST_SERVE_PX:
                raise AssertionError(f"dist serving {name}: sharded H {sv['corner_error_px_max']} px from the unsharded")
        if not corr["max_abs_err"] <= DIST_CORR_ATOL:
            raise AssertionError(f"dist corr: {corr['max_abs_err']} > {DIST_CORR_ATOL}")
        return out
    finally:
        dist.destroy_process_group()


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "gfnet_tpu_torch" / "csrc").is_dir() or not all(
            f.exists() for f in (HEAD_NPZ, TINY_HEAD, JAX_ACCURACY, ORACLE, FIXTURES, ORBAX_FIXTURES)):
        print(f"chip_smoke: run from a checkout of the repository ({ROOT} lacks gfnet_tpu_torch, "
              "the trained heads or the accuracy readings)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    LOG.unlink(missing_ok=True)  # this run's lines only
    t_start = time.perf_counter()
    seconds: dict = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0
            emit("phase_seconds", name=name, seconds=seconds[name])

    try:
        info = timed("device", phase_device, torch)
        timed("build", phase_build)
        k1, k1_wide = timed("k1", phase_k1, torch, info["exp_per_s"])
        k2 = timed("k2", phase_k2, torch)
        timed("tiny", phase_tiny, torch, np)
        flag, matcher, candidates = timed("flagship", phase_flagship, torch, np)
        k4 = timed("k4", phase_k4, torch, info["exp_per_s"], candidates)
        k5 = timed("k5", phase_k5, torch)
        k6 = timed("k6", phase_k6, torch)
        timed("flagship_f32", phase_flagship_f32, torch, np, matcher)
        acc_launches = timed("accuracy", phase_accuracy, torch, matcher)
        with tempfile.TemporaryDirectory() as d:  # the data phase's directories, read again by orbax
            data = timed("data", phase_data, torch, np, matcher, Path(d))
            timed("orbax", phase_orbax, torch, np, Path(d), data)
        k3 = timed("k3", phase_k3, torch)
        timed("tiny_train", phase_tiny_grads, torch, np)
        train = timed("trainer", phase_trainer, torch, np, matcher)
        timed("learn", phase_learn, torch)
        timed("ops_extra", phase_ops_extra, torch)
        timed("dist", phase_dist, torch, np, matcher)
    except Exception:
        traceback.print_exc()
        return 1
    # launches: per `estimate_homography` call for K1 and K2, per train step
    # for K3, which only the training path runs; and over the accuracy
    # phase's 200 evaluated pairs
    # K1's wide kernel, off the flagship's path, with its row; its launches
    # are the flagship pair's count of it, as the library reported them
    k1_routes = [{"name": k1_wide["route"], "route": "cuda", "source": "gfnet_tpu_torch/csrc/oneshot_attention.cu",
                  "replaces": "gfnet_tpu/ops/pallas/oneshot_attention.py:195",
                  "launches": flag["k1_kernels"].get(k1_wide["route"], 0),
                  "max_abs_err": k1_wide["max_abs_err"], "ms": k1_wide["kernel_ms"], "plain_ms": k1_wide["plain_ms"],
                  "bound_ms": k1_wide["bound_ms"], "bound_by": k1_wide["bound_by"],
                  "library_ms": k1_wide["library_ms"], "shape": k1_wide["shape"], "dtype": k1_wide["dtype"]}]
    summary = []
    for name, row, src, replaces, launches in (
        ("oneshot_attention", k1, "gfnet_tpu_torch/csrc/oneshot_attention.cu",
         "gfnet_tpu/ops/pallas/oneshot_attention.py:195", flag["launches"]),
        ("local_corr", k2, "gfnet_tpu_torch/csrc/local_corr.cu",
         "gfnet_tpu/ops/pallas/local_corr.py:219", flag["launches"]),
        ("local_corr_bwd", k3, "gfnet_tpu_torch/csrc/local_corr_bwd.cu",
         "gfnet_tpu/ops/pallas/local_corr.py:219 (_bwd_kernel)", train["launches_per_step"]),
        ("kde", k4, "gfnet_tpu_torch/csrc/kde.cu", "none (gfnet_tpu/ops/kde.py is left to XLA)",
         flag["launches"]),
        ("residual_norm", k5, "gfnet_tpu_torch/csrc/residual_norm.cu",
         "none (gfnet_tpu/models/vit.py's norms, LayerScale and adds are left to XLA)", flag["launches"]),
        ("refine_block", k6, "gfnet_tpu_torch/csrc/refine_block.cu",
         "none (gfnet_tpu/models/refiner.py's depthwise conv, BatchNorm and ReLU are left to XLA)", flag["launches"]),
    ):
        shape = row.get("shape") or {k: row[k] for k in ("query", "grad", "target", "radius", "target_dtype")
                                     if k in row}
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": shape,
                        **({"flow": row["flow"], "ms_random_flow": row["ms_random_flow"]} if "flow" in row else {}),
                        "launches_per_train_step": train["launches_per_step"][name],
                        "launches_accuracy": acc_launches[name],
                        **({"timed_kernel": row["route"], "launches_by_kernel": flag["k1_kernels"], "routes": k1_routes}
                           if name == "oneshot_attention" else {})})
    emit("total", seconds=time.perf_counter() - t_start, phase_seconds=seconds)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
