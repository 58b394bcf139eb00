"""What `chip_smoke.py`'s tolerance gates read when a kernel is slightly wrong.

Plants small faults at run time, by wrapping the kernel launchers of
`gfnet_tpu_torch.ops.kernels` (no file changes), and prints, one JSON line
each, the error the matching gate of `chip_smoke.py` would read beside that
gate's tolerance:

  - K1 with its softmax scale off by 1%, with the last 64 keys dropped, and
    with a stale ring stage (each 64-key tile of probabilities multiplied
    with the V tile before it), at the ViT and cross-view shapes of phase 3
    (bf16: the `wgmma` kernel at D=64, the `mma.sync` kernel at D=8); at D =
    320 (bf16, the wide kernel) the stale ring stage, k's channels 256-319
    zeroed (one K box left out of the logits) and v's columns 256-319
    replaced by 192-255 (a warpgroup reading its neighbour's box), each
    against K1's gate and the streamed gate (the plain version that sums the
    logits box by box), beside the sound kernel; and in float32 with q, k
    and v rounded to TF32 first (a single TF32 pass: what the float32 gate
    must catch), beside the sound float32 kernel, at those shapes and at D =
    128, 256 and 320 (`k1` runs these alone);
  - K2 with the centre tap of every window zeroed, at two shapes of phase 4;
  - the tiny config's `match()` on CUDA against the CPU (phase 5), with K1's
    scale off by 1% and with K2's centre tap zeroed;
  - K3 with the centre tap of the incoming gradient dropped, and with its
    1/√C scale off by 1%, at two shapes of phase 7 (float32);
  - K2 and K3 with the last column of every window dropped for the cells on
    a tile's right edge (an off-by-one in the staged box), on the homography
    flow at two shapes of phase 4 (bf16) and of phase 7 (float32);
  - the tiny config's train step on CUDA against the CPU (phase 8), sound and
    with each of the two K3 faults: the loss and the gradient gate;
  - the accuracy gate (the accuracy phase) on the flagship matcher: sound
    under the JAX reading's keys (the serial chain from `PRNGKey(0)`), then
    under the chains from `PRNGKey(1..3)` (other draws than JAX's: the
    sampling-noise floor the gate read before the port took JAX's keys, not
    gated), with K2's centre tap zeroed, with K1's scale off by 1%, and with
    the backbone `GFNetMatcher(seed=0)` drew before it drew the JAX
    package's (torch-seeded, its patch embedding U(±1/√588)).

  - the Orbax reader and weight bridge (`orbax` runs these alone, on the
    card or, without one, on the CPU): optax's `mu` and `nu` swapped, one
    square Dense kernel's `mu` left untransposed, AdamW's count one ahead,
    the zstd decoder built without rotating its repeat offsets (the source
    edited in a temporary copy), and one byte of a data file of the Orbax
    flagship head flipped (in a copy): the resumed update's max |Δ| against
    `ORBAX_RESUME_ATOL`, or what the read raises.

Exits 1 if a planted kernel fault stays inside its gate, or a sound run
does not pass its gate; the accuracy gate's faults are reported, caught or
not. Needs one GPU but for `orbax`; run from the repository root
(`accuracy` runs the accuracy gate's readings alone):

    python3 scripts/plant_faults_torch.py [accuracy | k1 | orbax]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gfnet_tpu_torch.ops import kernels  # noqa: E402
from gfnet_tpu_torch.ops.attention import (entropy_invariant_scale, scaled_dot_product_attention,  # noqa: E402
                                           streamed_attention_plain, tf32_round)
from gfnet_tpu_torch.ops.local_correlation import (_local_correlation_patch, _window_patches,  # noqa: E402
                                                   local_corr_dq_plain)

REAL_K1, REAL_K2, REAL_K3 = kernels.oneshot_attention, kernels.local_corr, kernels.local_corr_bwd


def k1_scale_off(q, k, v, scale):
    return REAL_K1(q, k, v, scale * 1.01)


def k1_tail_dropped(q, k, v, scale):
    return REAL_K1(q, k[:, :-64], v[:, :-64], scale)


def k1_stale_stage(q, k, v, scale):
    # tile i of P meets tile i-1 of V, as when a ring stage is read before its refill has landed
    return REAL_K1(q, k, torch.roll(v, 64, dims=1), scale)


def k1_box_dropped(q, k, v, scale):
    # k's channels 256-319 zeroed: the last K box of D = 320 left out of the logits
    k = k.clone()
    k[..., 256:320] = 0
    return REAL_K1(q, k, v, scale)


def k1_neighbour_box(q, k, v, scale):
    # v's columns 256-319 replaced by 192-255: a warpgroup reading its neighbour's V box
    v = v.clone()
    v[..., 256:320] = v[..., 192:256]
    return REAL_K1(q, k, v, scale)


def k1_tf32_single_pass(q, k, v, scale):
    # q, k, v rounded to TF32 before the launch: their low halves are zero, so
    # Q·Kᵀ is one TF32 pass and P·V two (P's own halves stay), as a float32
    # kernel on single-pass TF32 would read
    return REAL_K1(*(tf32_round(t) for t in (q, k, v)), scale)


def k2_centre_zeroed(query, target, flow, radius, **kw):
    out = REAL_K2(query, target, flow, radius, **kw)
    out[..., (2 * radius + 1) ** 2 // 2] = 0
    return out


def k3_centre_dropped(grad, target, flow, radius, **kw):
    grad = grad.clone()
    grad[..., (2 * radius + 1) ** 2 // 2] = 0
    return REAL_K3(grad, target, flow, radius, **kw)


def k3_scale_off(grad, target, flow, radius, **kw):
    return REAL_K3(grad, target, flow, radius, **kw) * 1.01


def _right_edge_last_column(target, flow, radius, query_rows):
    """The patches' last column (N, win, C) float32, zeroed except for the
    cells on their tile's right edge (as K2, `query_rows`, or K3 tiles this
    launch), and the corner offsets fx, fy (N, 1)."""
    b, g1, g2, _ = flow.shape
    _, h, w, c = target.shape
    tile = kernels.corr_schedule(radius, c, target.element_size(), h, w, g1, g2, b, query_rows).tile
    patches, fx, fy = _window_patches(target, flow, radius)
    gx = torch.arange(g2, device=flow.device)
    edge = ((gx % tile[1] == tile[1] - 1) | (gx == g2 - 1)).expand(b, g1, g2).reshape(-1)
    return patches[:, :, -1, :].float() * edge[:, None, None], fx[:, 0], fy[:, 0]


def k2_right_edge_column_dropped(query, target, flow, radius):
    out = REAL_K2(query, target, flow, radius)
    col, fx, fy = _right_edge_last_column(target, flow, radius, True)
    c = query.shape[-1]
    s = (col * query.reshape(-1, 1, c).float()).sum(-1)  # dots of the last column (N, win)
    # the column meets the taps kx = 2r through the corners w01 and w11
    lost = ((1 - fy) * fx * s[:, :-1] + fy * fx * s[:, 1:]) / c**0.5
    out = out.reshape(len(s), 2 * radius + 1, 2 * radius + 1).clone()
    out[:, :, -1] -= lost
    return out.reshape(query.shape[:3] + (-1,))


def k3_right_edge_column_dropped(grad, target, flow, radius):
    dq = REAL_K3(grad, target, flow, radius)
    col, fx, fy = _right_edge_last_column(target, flow, radius, False)
    taps = 2 * radius + 1
    g = grad.reshape(-1, taps, taps)[:, :, -1]  # the gradient of taps kx = 2r
    sw = torch.zeros_like(col[..., 0])
    sw[:, :-1] += (1 - fy) * fx * g
    sw[:, 1:] += fy * fx * g
    lost = torch.einsum("ny,nyc->nc", sw, col) / target.shape[-1] ** 0.5
    return dq - lost.reshape(dq.shape)


def report(fault: str, gate: str, err: float, tol: float, caught: list) -> None:
    caught.append(err > tol)
    print(json.dumps({"fault": fault, "gate": gate, "max_abs_err": err, "atol": tol,
                      "caught": err > tol}), flush=True)


def k1_faults(caught: list) -> None:
    """The bf16 faults at the ViT and cross-view shapes; then float32: the
    sound kernel (its reading must pass) and a single TF32 pass, at those
    shapes, D = 128 and 256 (kv split) and 320 (column groups)."""
    gen = torch.Generator("cuda").manual_seed(1)
    for b, n, h, d in ((2, 1601, 16, 64), (2, 1600, 8, 8)):
        scale = 64**-0.5 if d == 64 else entropy_invariant_scale(8, n, 1024)
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        want = scaled_dot_product_attention(q.float(), k.float(), v.float(), scale)
        for fault in (k1_scale_off, k1_tail_dropped, k1_stale_stage):
            err = (fault(q, k, v, scale).float() - want).abs().max().item()
            report(f"{fault.__name__} {[b, n, h, d]}", "k1", err, chip_smoke.K1_ATOL, caught)
    # the wide kernel (bf16, D = 320, kv split 4 ways): each fault against both
    # of its gates, and the sound kernel, which must pass both
    b, n, h, d = 2, 1024, 1, 320
    scale = d**-0.5
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    want = scaled_dot_product_attention(q.float(), k.float(), v.float(), scale)
    streamed = streamed_attention_plain(q, k, v, scale, box=64).float()
    for fault in (None, k1_stale_stage, k1_box_dropped, k1_neighbour_box):
        got = (fault or REAL_K1)(q, k, v, scale).float()
        readings = {"k1": ((got - want).abs().max().item(), chip_smoke.K1_ATOL),
                    "k1_streamed": (((got - streamed).abs().max() / streamed.abs().max()).item(),
                                    chip_smoke.K1_STREAMED_RTOL)}
        for gate, (err, tol) in readings.items():
            if fault is None:
                caught.append(err <= tol)
                print(json.dumps({"sound": f"k1 bf16 {[b, n, h, d]}", "gate": gate, "max_err": err, "tol": tol,
                                  "passes": err <= tol}), flush=True)
            else:
                report(f"{fault.__name__} {[b, n, h, d]}", gate, err, tol, caught)
    for b, n, h, d in ((2, 1601, 16, 64), (2, 1600, 8, 8), (1, 6401, 16, 64), (2, 1024, 1, 128),
                       (2, 1024, 1, 256), (2, 1024, 1, 320)):
        scale = entropy_invariant_scale(8, n, 1024) if d == 8 else d**-0.5
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda") for _ in range(3))
        want = scaled_dot_product_attention(q, k, v, scale)
        sound = (REAL_K1(q, k, v, scale) - want).abs().max().item()
        caught.append(sound <= chip_smoke.K1_F32_ATOL)
        print(json.dumps({"sound": f"k1 float32 {[b, n, h, d]}", "gate": "k1_f32", "max_abs_err": sound,
                          "atol": chip_smoke.K1_F32_ATOL, "passes": sound <= chip_smoke.K1_F32_ATOL}), flush=True)
        err = (k1_tf32_single_pass(q, k, v, scale) - want).abs().max().item()
        report(f"k1_tf32_single_pass {[b, n, h, d]}", "k1_f32", err, chip_smoke.K1_F32_ATOL, caught)


def kernel_faults(caught: list) -> None:
    k1_faults(caught)
    gen = torch.Generator("cuda").manual_seed(1)
    for r, c, t, g in ((7, 64, 32, 32), (2, 16, 280, 160)):
        query = torch.randn((2, g, g, c), generator=gen, device="cuda").to(torch.bfloat16)
        target = torch.randn((2, t, t, c), generator=gen, device="cuda").to(torch.bfloat16)
        flow = torch.rand((2, g, g, 2), generator=gen, device="cuda") * 2.2 - 1.1
        err = (k2_centre_zeroed(query, target, flow, r)
               - _local_correlation_patch(query, target, flow, r)).abs().max().item()
        report(f"k2_centre_zeroed r{r} q{g} t{t} C{c}", "k2", err, chip_smoke.K2_ATOL, caught)
    for i, (r, c, t, g) in enumerate(((6, 64, 70, 40), (2, 16, 280, 160))):
        query = torch.randn((2, g, g, c), generator=gen, device="cuda").to(torch.bfloat16)
        target = torch.randn((2, t, t, c), generator=gen, device="cuda").to(torch.bfloat16)
        flow = chip_smoke.corr_flow(torch, "homography", 2, g, t, 40 + i)
        err = (k2_right_edge_column_dropped(query, target, flow, r)
               - _local_correlation_patch(query, target, flow, r)).abs().max().item()
        report(f"k2_right_edge_column_dropped r{r} q{g} t{t} C{c} homography", "k2", err,
               chip_smoke.K2_ATOL, caught)


def k3_faults(caught: list) -> None:
    gen = torch.Generator("cuda").manual_seed(7)
    for r, c, t, g in (chip_smoke.TRAIN_CORR_SHAPES[0], chip_smoke.TRAIN_CORR_SHAPES[-1]):
        b = chip_smoke.TRAIN_BATCH
        target = torch.randn((b, t, t, c), generator=gen, device="cuda")
        flow = torch.rand((b, g, g, 2), generator=gen, device="cuda") * 2.2 - 1.1
        grad = torch.randn((b, g, g, (2 * r + 1) ** 2), generator=gen, device="cuda")
        want = local_corr_dq_plain(grad, target, flow, r)
        for fault in (k3_centre_dropped, k3_scale_off):
            err = (fault(grad, target, flow, r) - want).abs().max().item()
            report(f"{fault.__name__} r{r} q{g} t{t} C{c}", "k3", err, chip_smoke.K3_ATOL, caught)
    for i, (r, c, t, g) in enumerate((chip_smoke.TRAIN_CORR_SHAPES[1], chip_smoke.TRAIN_CORR_SHAPES[-1])):
        b = chip_smoke.TRAIN_BATCH
        query = torch.randn((b, g, g, c), generator=gen, device="cuda")
        target = torch.randn((b, t, t, c), generator=gen, device="cuda")
        flow = chip_smoke.corr_flow(torch, "homography", b, g, t, 50 + i)
        grad = torch.randn((b, g, g, (2 * r + 1) ** 2), generator=gen, device="cuda")
        err = (k3_right_edge_column_dropped(grad, target, flow, r)
               - local_corr_dq_plain(grad, target, flow, r)).abs().max().item()
        report(f"k3_right_edge_column_dropped r{r} q{g} t{t} C{c} homography", "k3", err,
               chip_smoke.K3_ATOL, caught)
        err = (k2_right_edge_column_dropped(query, target, flow, r)
               - _local_correlation_patch(query, target, flow, r)).abs().max().item()
        report(f"k2_right_edge_column_dropped r{r} q{g} t{t} C{c} float32 homography", "k2", err,
               chip_smoke.K2_ATOL, caught)


def tiny_train_faults(caught: list) -> None:
    for fault in (None, k3_centre_dropped, k3_scale_off):
        if fault is not None:
            kernels.local_corr_bwd = fault
        try:
            r = chip_smoke.tiny_train_compare(torch, np)
        finally:
            kernels.local_corr_bwd = REAL_K3
        name = fault.__name__ if fault else "no fault"
        print(json.dumps({"fault": f"tiny train step with {name}", "gate": "tiny_train_cuda_vs_cpu",
                          "loss_rel_err": r["loss_rel_err"], "loss_rtol": r["loss_rtol"],
                          "grad_max_rel_err": r["grad_max_rel_err"], "grad_rtol": r["grad_rtol"],
                          "grad_worst_leaf": r["grad_worst_leaf"],
                          "caught": r["grad_max_rel_err"] > r["grad_rtol"]}), flush=True)
        # the sound run must pass its gate, a faulty one must not
        caught.append((r["grad_max_rel_err"] > r["grad_rtol"]) == (fault is not None))


def tiny_faults(caught: list) -> None:
    gpu, cpu, a, b = chip_smoke.tiny_setup(torch, np)
    wc, cc = cpu.match(a, b)
    for name, fault in (("oneshot_attention", k1_scale_off), ("local_corr", k2_centre_zeroed)):
        setattr(kernels, name, fault)
        try:
            wg, cg = gpu.match(a, b)
        finally:
            setattr(kernels, name, REAL_K1 if name == "oneshot_attention" else REAL_K2)
        err = max((wg.cpu() - wc).abs().max().item(), (cg.cpu() - cc).abs().max().item())
        report(f"tiny match with {fault.__name__}", "tiny_cuda_vs_cpu", err, chip_smoke.E2E_ATOL, caught)


@torch.no_grad()
def backbone_before_jax_draw(cfg, seed: int = 0) -> dict:
    """The ViT state `GFNetMatcher(cfg, seed=seed)` drew before it drew the
    JAX package's: a torch generator seeded with `seed`, Dense weights
    truncated normal, every conv (the patch embedding too) U(±1/√fan_in),
    then the cls token N(0, 1e-6) and the pos-embed N(0, 0.02)."""
    from gfnet_tpu_torch.models.common import Conv, Dense
    from gfnet_tpu_torch.models.vit import VisionTransformer

    gen = torch.Generator().manual_seed(seed)
    vit = VisionTransformer(cfg.dino, dtype=torch.float32)
    for m in vit.modules():
        if isinstance(m, Dense):
            std = 1.0 / m.in_features**0.5 / 0.87962566103423978
            torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            m.bias.zero_()
        elif isinstance(m, Conv):
            bound = 1.0 / m.weight[0].numel() ** 0.5
            m.weight.uniform_(-bound, bound, generator=gen)
            m.bias.zero_()
    vit.cls_token.normal_(0.0, 1e-6, generator=gen)
    vit.pos_embed.normal_(0.0, 0.02, generator=gen)
    return vit.state_dict()


def accuracy_report(what: str, reading: dict, sound: bool, caught: list) -> None:
    failures = chip_smoke.accuracy_failures(reading)
    summary = {name: {k: r[k] for k in ("mace_minus_oracle", "mace_jax_pairs_port", "mace_jax_pairs_jax",
                                        "pair_abs_diff_median", "pair_abs_diff_max", "ace_port_jax")}
               | {"mace": r["results"][f"mace_{name}"]}
               for name, r in reading.items() if isinstance(r, dict)}
    print(json.dumps({"fault": what, "gate": "accuracy",
                      "pair_abs_diff_registered_mean": reading["pair_abs_diff_registered_mean"],
                      "registered_pairs": reading["registered_pairs"],
                      "pair_tol": chip_smoke.ACC_PAIR_TOL, "mace_tol": chip_smoke.ACC_MACE_TOL,
                      "sets": summary, "failures": failures, "caught": bool(failures)}), flush=True)
    if sound:
        caught.append(not failures)


def accuracy_faults(caught: list) -> None:
    from gfnet_tpu_torch.matcher import GFNetMatcher

    m = GFNetMatcher.from_pretrained(ckpt_path=str(chip_smoke.HEAD_NPZ), device="cuda",
                                     dtype=torch.bfloat16, seed=0)
    sets, _ = chip_smoke.accuracy_pairs(torch)
    accuracy_report("no fault, the JAX reading's keys (PRNGKey(0))",
                    chip_smoke.accuracy_reading(torch, m, sets, 0), True, caught)
    for seed in (1, 2, 3):
        accuracy_report(f"no fault, keys from PRNGKey({seed}) (not JAX's draws)",
                        chip_smoke.accuracy_reading(torch, m, sets, seed), False, [])
    for name, fault in (("local_corr", k2_centre_zeroed), ("oneshot_attention", k1_scale_off)):
        setattr(kernels, name, fault)
        try:
            reading = chip_smoke.accuracy_reading(torch, m, sets)
        finally:
            setattr(kernels, name, REAL_K1 if name == "oneshot_attention" else REAL_K2)
        accuracy_report(f"accuracy with {fault.__name__}", reading, False, caught)
    m.vit.load_state_dict(backbone_before_jax_draw(m.cfg, 0))
    accuracy_report("accuracy with the backbone drawn before the JAX draw (torch-seeded)",
                    chip_smoke.accuracy_reading(torch, m, sets), False, caught)


def _orbax_update_reading(fault: str, caught: list, **kw) -> None:
    import shutil
    import tempfile

    device = "cuda" if torch.cuda.is_available() else "cpu"
    with tempfile.TemporaryDirectory() as d:
        ws = Path(d) / "ws"
        shutil.copytree(chip_smoke.ORBAX_FIXTURES / "tiny_run", ws)
        try:
            err = chip_smoke.orbax_third_update(torch, np, ws, device=device, **kw)["max_abs_diff"]
        except (ValueError, RuntimeError) as e:
            caught.append(True)
            print(json.dumps({"fault": fault, "gate": "orbax (d)", "raised": str(e)[:300], "caught": True}),
                  flush=True)
            return
    tol = chip_smoke.ORBAX_RESUME_ATOL
    caught.append(not err <= tol)  # as the phase reads it: NaN fails the gate
    print(json.dumps({"fault": fault, "gate": "orbax (d) third update", "max_abs_err": err, "atol": tol,
                      "caught": not err <= tol}), flush=True)


def orbax_faults(caught: list) -> None:
    """The reader's and the bridge's faults against the orbax phase's gates."""
    import ctypes
    import shutil
    import subprocess
    import tempfile
    from unittest import mock

    from gfnet_tpu_torch.utils import convert, hostlib, orbax

    sound: list = []
    _orbax_update_reading("sound", sound)
    caught.append(not sound[0])  # the sound reading passes its gate
    real_read = orbax.read_checkpoint

    def swapped(path):
        tree = real_read(path)
        adam = tree["opt_state"]["1"]["0"]
        adam["mu"], adam["nu"] = adam["nu"], adam["mu"]
        return tree

    with mock.patch.object(orbax, "read_checkpoint", swapped):
        _orbax_update_reading("mu and nu swapped", caught)

    real_moments = convert.flax_to_torch_head_moments
    calls = []

    def untransposed(moments, stats):
        out = real_moments(moments, stats)
        calls.append(1)
        if len(calls) == 1:  # mu only: the crossview's first k projection (square)
            name = "dino_decoder.cross_attn_blocks.0.attn.k_proj.weight"
            out[name] = out[name].T.contiguous()
        return out

    with mock.patch.object(convert, "flax_to_torch_head_moments", untransposed):
        _orbax_update_reading("one square Dense mu not transposed", caught)
    _orbax_update_reading("AdamW count one ahead", caught, count_offset=1)

    source = orbax.SOURCE.read_text()
    rotate = ("        rep[2] = rep[1];\n        rep[1] = rep[0];\n        rep[0] = (uint32_t)offset;\n"
              "      } else {")
    assert source.count(rotate) == 1
    with tempfile.TemporaryDirectory() as d:
        mutant = Path(d) / "zstd_no_rotate.cpp"
        mutant.write_text(source.replace(rotate, "        rep[0] = (uint32_t)offset;\n      } else {"))
        lib_path = Path(d) / "libmutant.so"
        subprocess.run([hostlib.compiler(), *hostlib.CXX_FLAGS, str(mutant), "-o", str(lib_path)], check=True)
        lib = ctypes.CDLL(str(lib_path))
        real_lib = orbax.load_library()
        for fn in ("gfnet_zstd_decompress", "gfnet_zstd_content_size", "gfnet_crc32c"):
            getattr(lib, fn).argtypes = getattr(real_lib, fn).argtypes
            getattr(lib, fn).restype = getattr(real_lib, fn).restype
        with mock.patch.object(orbax, "load_library", lambda: lib):
            _orbax_read_reading("zstd repeat offsets not rotated", caught)

    with tempfile.TemporaryDirectory() as d:
        head = Path(d) / "flagship_head"
        shutil.copytree(chip_smoke.ORBAX_FIXTURES / "flagship_head", head)
        biggest = max((f for f in head.rglob("d/*") if f.is_file()), key=lambda f: f.stat().st_size)
        raw = bytearray(biggest.read_bytes())
        raw[len(raw) // 3] ^= 0x04
        biggest.write_bytes(bytes(raw))
        _orbax_read_reading("one byte of a data file flipped", caught, head)


def _orbax_read_reading(fault: str, caught: list, head: Path | None = None) -> None:
    """Part (a) of the orbax phase under a fault: the Orbax flagship head
    against `load_head_npz(r5b)`, bit for bit, or what the read raises."""
    from gfnet_tpu_torch.utils.convert import load_head, load_head_npz

    head = head or chip_smoke.ORBAX_FIXTURES / "flagship_head"
    try:
        sd, _ = load_head(str(head))
    except ValueError as e:
        caught.append(True)
        print(json.dumps({"fault": fault, "gate": "orbax (a) read", "raised": str(e)[:300], "caught": True}),
              flush=True)
        return
    want, _ = load_head_npz(str(chip_smoke.HEAD_NPZ))
    err = max(float((sd[k] - want[k]).abs().max()) for k in want)
    report(fault, "orbax (a) read, bit for bit", err, 0.0, caught)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv == ["orbax"]:
        caught: list = []
        orbax_faults(caught)
        return 0 if all(caught) else 1
    if not torch.cuda.is_available():
        print("plant_faults_torch: needs a GPU", file=sys.stderr)
        return 2
    chip_smoke.phase_device(torch)
    caught: list = []
    if argv == ["k1"]:
        k1_faults(caught)
        return 0 if all(caught) else 1
    if argv != ["accuracy"]:
        kernel_faults(caught)
        tiny_faults(caught)
        k3_faults(caught)
        tiny_train_faults(caught)
    accuracy_faults(caught)
    return 0 if all(caught) else 1


if __name__ == "__main__":
    sys.exit(main())
