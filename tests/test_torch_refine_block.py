"""The refiner block on the CPU (`models/refiner.RefineBlock`): the four
modules' composition bit for bit, in eval and in training, with the state
dict it always had and no K6 launch; K6's tile plan (`ops/kernels.refine_plan`)
at every shape the refiners run, in bf16 and in float32. K6 itself is held against the composition
on the card by tests/test_torch_cuda_kernels.py.
"""

import copy

import pytest
import torch
import torch.nn as nn

from gfnet_tpu_torch.models.refiner import ConvRefiner, RefineBlock
from gfnet_tpu_torch.ops import kernels
from gfnet_tpu_torch.utils import profiling
from torch_cpu import one_thread  # noqa: F401

# the refiners of the shipped configs, scales 16, 8, 4, 2, 1: (width, displacement dim, radius),
# width = 2 · features + displacement dim + (2r + 1)²
REFINERS = ((417, 64, 7), (361, 64, 6), (177, 32, 4), (73, 16, 2), (24, 8, 0))
WIDTHS = [c for c, _, _ in REFINERS]
# (B', G, C) of a refiner call: pass 1 at 448² and pass 2 at 560², symmetric
# batches of 8 pairs (16) and single pairs (2)
PASS_SHAPES = [(g, c) for g, c in zip((32, 32, 64, 128, 256), WIDTHS)] + \
              [(g, c) for g, c in zip((40, 80, 160, 320), WIDTHS[1:])]
H100_SMS = 132


def seeded_block(c: int, dtype: torch.dtype, seed: int = 0) -> RefineBlock:
    """A refine block of width c with every parameter and running statistic
    drawn away from its initial value."""
    gen = torch.Generator().manual_seed(seed)
    blk = RefineBlock(c, 5, dtype)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=gen))
        blk[1].weight.add_(1.0)
        blk[1].running_mean.copy_(0.3 * torch.randn(c, generator=gen))
        blk[1].running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return blk


def block_input(c: int, dtype: torch.dtype, seed: int = 1) -> torch.Tensor:
    return torch.randn((2, 7, 6, c), generator=torch.Generator().manual_seed(seed)).to(dtype)


@pytest.mark.parametrize("c", WIDTHS)
def test_refine_block_on_the_cpu_is_the_plain_composition(c):
    for dtype in (torch.bfloat16, torch.float32):
        blk = seeded_block(c, dtype).eval()
        x = block_input(c, dtype)
        plain = nn.Sequential(*blk)  # the same modules, composed as before K6
        with torch.no_grad():
            got, want = blk(x), plain(x)
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.equal(blk(x), plain(x))  # with grad on too


@pytest.mark.parametrize("c", WIDTHS)
def test_refine_block_training_moves_running_statistics_as_before(c):
    blk = seeded_block(c, torch.bfloat16).train()
    plain = nn.Sequential(*copy.deepcopy(blk)).train()
    x = block_input(c, torch.bfloat16)
    for _ in range(2):
        got, want = blk(x), plain(x)
        assert torch.equal(got, want)
        got.float().square().sum().backward()
        want.float().square().sum().backward()
    for (name, a), b in zip(blk.state_dict().items(), plain.state_dict().values()):
        assert torch.equal(a, b), name
    assert not torch.equal(blk[1].running_mean, seeded_block(c, torch.bfloat16)[1].running_mean)
    for (name, p), q in zip(blk.named_parameters(), plain.parameters()):
        assert torch.equal(p.grad, q.grad), name


@pytest.mark.parametrize("c,disp,radius", REFINERS)
def test_conv_refiner_state_dict_keys_are_unchanged(c, disp, radius):
    block = [f"{m}.{p}" for m, p in (("0", "weight"), ("0", "bias"), ("1", "weight"), ("1", "bias"),
                                      ("1", "running_mean"), ("1", "running_var"), ("3", "weight"), ("3", "bias"))]
    want = (["disp_emb.weight", "disp_emb.bias"] + [f"block1.{k}" for k in block]
            + [f"hidden_blocks.{j}.{k}" for j in range(8) for k in block] + ["out_conv.weight", "out_conv.bias"])
    sd = ConvRefiner(c, disp, radius).state_dict()
    assert list(sd) == want
    assert sd["block1.0.weight"].shape == (c, 1, 5, 5) and sd["hidden_blocks.7.3.weight"].shape == (c, c, 1, 1)


def test_k6_counter_is_registered_and_reset():
    assert kernels.COUNTERS["refine_block"] == "k6.launches"
    kernels.reset_launch_counts()
    profiling.count("k6.launches")
    assert kernels.launch_counts()["refine_block"] == 1
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["refine_block"] == 0


@pytest.mark.parametrize("c", WIDTHS)
def test_no_k6_launch_on_the_cpu_or_in_training(c):
    blk = seeded_block(c, torch.bfloat16)
    x = block_input(c, torch.bfloat16)
    before = kernels.launch_counts()
    with torch.no_grad():
        blk.eval()(x)
    blk.train()(x).float().sum().backward()
    assert kernels.launch_counts() == before


def plan_fits(b, h, w, c, rows, pixels, itemsize=2):
    """The tile fits a block (threads, shared memory), and gives every SM of
    an H100 two tiles, or is the smallest tile the plan cuts to."""
    assert rows in kernels.REFINE_TILE_ROWS and pixels in kernels.REFINE_TILE_PIXELS
    assert kernels.refine_threads(pixels, c) <= kernels.REFINE_MAX_THREADS
    assert kernels.refine_smem(rows, pixels, c, itemsize) <= kernels.REFINE_SMEM_BUDGET
    tiles = b * -(-h // rows) * -(-w // pixels)
    smallest = rows <= kernels.REFINE_SPLIT_ROWS and pixels == kernels.REFINE_TILE_PIXELS[-1]
    assert tiles >= kernels.REFINE_TILES_PER_SM * H100_SMS or smallest
    return tiles


@pytest.mark.parametrize("b", [2, 16])
@pytest.mark.parametrize("g,c", PASS_SHAPES)
def test_refine_plan_fits_the_card_at_every_refiner_shape(b, g, c):
    """Every refiner call's tile fits a block; a batch call's (B' = 16) gives
    each SM two tiles with at most 3 staged pixels an output, and a single
    pair's (B' = 2, the serve cell) nearly one an SM where the smallest tile
    is left (G = 32, C = 417 and 361: 128 tiles on 132 SMs)."""
    rows, pixels = kernels.refine_plan(b, g, g, c, H100_SMS)
    tiles = plan_fits(b, g, g, c, rows, pixels)
    if b == 16:
        assert tiles >= kernels.REFINE_TILES_PER_SM * H100_SMS
        assert (rows + 4) * (pixels + 4) / (rows * pixels) <= 3.0
    else:
        assert tiles >= 128


@pytest.mark.parametrize("b", [2, 16])
@pytest.mark.parametrize("g,c", PASS_SHAPES)
def test_refine_plan_fits_the_card_in_float32(b, g, c):
    """The float32 model's tiles: each fits a block with float32's stage, as
    tall as the bf16 tile or shorter (1 row at C = 417, the only fit), never
    wider, and a batch call's still gives each SM two tiles."""
    rows, pixels = kernels.refine_plan(b, g, g, c, H100_SMS, 4)
    tiles = plan_fits(b, g, g, c, rows, pixels, 4)
    rows16, pixels16 = kernels.refine_plan(b, g, g, c, H100_SMS)
    assert rows <= rows16 and pixels <= pixels16
    assert rows >= kernels.REFINE_SPLIT_ROWS or kernels.refine_smem(2, pixels, c, 4) > kernels.REFINE_SMEM_BUDGET
    if b == 16:
        assert tiles >= kernels.REFINE_TILES_PER_SM * H100_SMS


@pytest.mark.parametrize("b,h,w,c", [(3, 37, 29, 73), (16, 37, 29, 73), (1, 5, 3, 24), (2, 19, 33, 417)])
def test_refine_plan_takes_a_ragged_grid(b, h, w, c):
    plan_fits(b, h, w, c, *kernels.refine_plan(b, h, w, c, H100_SMS))
    plan_fits(b, h, w, c, *kernels.refine_plan(b, h, w, c, H100_SMS, 4), 4)


def test_refine_plan_refuses_what_no_tile_holds():
    with pytest.raises(ValueError, match="no tile"):
        kernels.refine_plan(2, 32, 32, 513, H100_SMS)
    with pytest.raises(ValueError, match="no tile"):  # float32's 1-row stage at 480 channels: 115,280 bytes
        kernels.refine_plan(2, 32, 32, 480, H100_SMS, 4)
