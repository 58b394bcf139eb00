"""Local correlation windows around the current flow estimate.

Counterpart of `gfnet_tpu/ops/local_correlation.py` (ref
`utils/local_correlation.py:4-72`): for each query cell on the G x G grid,
the (2r+1)² window of the target map sampled bilinearly (zeros padding,
align_corners=False) at `flow + integer-pixel offsets`, each tap dotted
with the query feature / √C, ordered ky-major.

`local_correlation` launches the hand-written CUDA kernels for CUDA tensors:
K2 (`ops/kernels.py`, `csrc/local_corr.cu`) forward and K3
(`csrc/local_corr_bwd.cu`) for the gradient, which reaches the query only.
CPU tensors take the plain `_local_correlation_patch` with target and flow
detached; `local_corr_dq_plain` is K3's plain version. A shape the kernels
cannot take raises. `_local_correlation_gather` is the JAX package's plain
gather form (`grid_sample` at each tap), and `local_correlation_multilevel`
runs `local_correlation` over an average-pooled pyramid of the target; no
shipped config reaches either.

The kernels give each block a tile of neighbouring cells and stage the union
of their windows in shared memory where it fits a box of the launch
(`csrc/local_corr_window.cuh`). `corr_tile_boxes` repeats that decision, and
`local_corr_tiled_plain` / `local_corr_dq_tiled_plain` repeat the schedule
(tile → union box → patches gathered from the staged box or per cell) in
PyTorch, so that the CPU tests reach its indexing: they gather the patches
as the kernels fetch them and hand them to the plain versions' arithmetic.
Tests and `chip_smoke.py` use them, the model does not.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gfnet_tpu_torch.ops import kernels
from gfnet_tpu_torch.ops.sampler import grid_sample

Tensor = torch.Tensor


def window_offsets(radius: int, h: int, w: int) -> np.ndarray:
    """(K, 2) xy normalized offsets, K = (2r+1)², row-major in y then x:
    one target pixel per step."""
    r = radius
    oy = np.linspace(-2 * r / h, 2 * r / h, 2 * r + 1)
    ox = np.linspace(-2 * r / w, 2 * r / w, 2 * r + 1)
    gy, gx = np.meshgrid(oy, ox, indexing="ij")
    return np.stack([gx, gy], axis=-1).reshape(-1, 2).astype(np.float32)


def _local_correlation_gather(query: Tensor, target: Tensor, flow: Tensor, radius: int,
                              chunk: int = 32) -> Tensor:
    """The gather form (`gfnet_tpu/ops/local_correlation.py:45-68`): the
    target bilinearly sampled (`grid_sample`, zeros padding) at flow +
    `window_offsets`, `chunk` taps at a time, each dotted with the query /
    √C → (B, G1, G2, (2r+1)²), in the query's dtype. The same function as
    `_local_correlation_patch` and K2."""
    _, _, _, c = query.shape
    _, h, w, _ = target.shape
    offs = torch.from_numpy(window_offsets(radius, h, w)).to(flow.device)
    outs = []
    for k0 in range(0, offs.shape[0], chunk):
        pos = flow[:, :, :, None, :] + offs[None, None, None, k0:k0 + chunk]
        samp = grid_sample(target, pos)  # (B, G1, G2, kb, C)
        outs.append(torch.einsum("bijkc,bijc->bijk", samp, query) / float(np.sqrt(c)))
    return torch.cat(outs, dim=-1)


def target_pyramid(target: Tensor, num_levels: int) -> list[Tensor]:
    """`num_levels` targets, each the previous one average-pooled 2 × 2
    (B, H, W, C), the first the target itself."""
    levels = [target]
    for _ in range(num_levels - 1):
        b, h, w, c = levels[-1].shape
        levels.append(levels[-1].reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4)))
    return levels


def local_correlation_multilevel(query: Tensor, target: Tensor, flow: Tensor, radius: int,
                                 num_levels: int) -> Tensor:
    """`local_correlation` at each level of `target_pyramid`, concatenated
    level-major → (B, G1, G2, num_levels · (2r+1)²)
    (`gfnet_tpu/ops/local_correlation.py:71-85`): K2 on CUDA tensors, the
    plain version on CPU tensors."""
    return torch.cat([local_correlation(query, t, flow, radius) for t in target_pyramid(target, num_levels)],
                     dim=-1)


def _window_patches(target: Tensor, flow: Tensor, radius: int):
    """Each cell's (2r+2)² integer patch of the zero-padded target, (N, win,
    win, C) with N = B·G1·G2, and its fractional offsets fx, fy (N, 1, 1).
    A window that misses the map, or a non-finite flow, lands wholly in the
    zero margin."""
    b, g1, g2, _ = flow.shape
    _, h, w, _ = target.shape
    win = 2 * radius + 2
    pad = win  # clamped windows land wholly in this zero margin
    flow = flow.float()
    px = ((flow[..., 0] + 1) * w - 1) * 0.5
    py = ((flow[..., 1] + 1) * h - 1) * 0.5
    px = torch.where(torch.isfinite(px), px, torch.full_like(px, -1e9))
    py = torch.where(torch.isfinite(py), py, torch.full_like(py, -1e9))
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = (px - x0).reshape(-1, 1, 1)
    fy = (py - y0).reshape(-1, 1, 1)
    bx = (x0.to(torch.int64) - radius + pad).clamp(0, w + 2 * pad - win).reshape(-1)
    by = (y0.to(torch.int64) - radius + pad).clamp(0, h + 2 * pad - win).reshape(-1)

    tp = torch.nn.functional.pad(target, (0, 0, pad, pad, pad, pad))
    ar = torch.arange(win, device=target.device)
    bidx = torch.arange(b, device=target.device).repeat_interleave(g1 * g2)
    patches = tp[bidx[:, None, None], (by[:, None] + ar)[:, :, None], (bx[:, None] + ar)[:, None, :]]
    return patches, fx, fy


def _local_correlation_patch(query: Tensor, target: Tensor, flow: Tensor, radius: int,
                             patches=None, scale: float | None = None) -> Tensor:
    """Plain version of K2. All (2r+1)² taps of a cell share one fractional
    offset on the integer pixel lattice, so one (2r+2)² patch of the
    zero-padded target and a four-corner combine reproduce bilinear
    zeros-padding sampling exactly. Dots and combine in float32. `patches`:
    (patches, fx, fy) gathered otherwise, as `_tiled_patches` gathers them;
    by default `_window_patches`'. `scale`: the dots', by default 1/√C (the
    kernels take the caller's where it padded C: `pad_channels`)."""
    b, g1, g2, c = query.shape
    win = 2 * radius + 2
    patches, fx, fy = _window_patches(target, flow, radius) if patches is None else patches
    q = query.reshape(b * g1 * g2, 1, 1, c).float()
    s = (patches.float() * q).sum(-1)  # (N, win, win)
    comb = (
        (1 - fy) * (1 - fx) * s[:, : win - 1, : win - 1]
        + (1 - fy) * fx * s[:, : win - 1, 1:]
        + fy * (1 - fx) * s[:, 1:, : win - 1]
        + fy * fx * s[:, 1:, 1:]
    )
    comb = comb.reshape(b, g1, g2, (2 * radius + 1) ** 2)
    return comb / float(np.sqrt(c)) if scale is None else comb * scale


def local_corr_dq_plain(g: Tensor, target: Tensor, flow: Tensor, radius: int, patches=None,
                        scale: float | None = None) -> Tensor:
    """Plain version of K3: the gradient of `_local_correlation_patch` in the
    query, written out. g (B, G1, G2, (2r+1)²) is spread over the (2r+2)²
    patch with the four corner weights (the adjoint of the combine), then
    contracted with the target patch and scaled by 1/√C → (B, G1, G2, C)
    float32. Target and flow get no gradient. `patches` and `scale` as for
    `_local_correlation_patch`."""
    b, g1, g2, k = g.shape
    c = target.shape[-1]
    win, taps = 2 * radius + 2, 2 * radius + 1
    patches, fx, fy = _window_patches(target, flow, radius) if patches is None else patches
    gt = g.float().reshape(b * g1 * g2, taps, taps)
    sw = gt.new_zeros((b * g1 * g2, win, win))
    sw[:, : win - 1, : win - 1] += (1 - fy) * (1 - fx) * gt
    sw[:, : win - 1, 1:] += (1 - fy) * fx * gt
    sw[:, 1:, : win - 1] += fy * (1 - fx) * gt
    sw[:, 1:, 1:] += fy * fx * gt
    dq = torch.einsum("nyx,nyxc->nc", sw, patches.float())
    dq = dq.reshape(b, g1, g2, c)
    return dq / float(np.sqrt(c)) if scale is None else dq * scale


def _corr_windows(flow: Tensor, h: int, w: int, radius: int):
    """Each cell's window as `corr_window` in `csrc/local_corr_window.cuh`
    computes it: the patch base x0, y0 (int64, 0 where outside), the
    fractional offsets fx, fy, and `outside` (the patch misses the map, or
    the flow is not finite). float32, one rounding an operation."""
    flow = flow.float()
    px = ((flow[..., 0] + 1) * w - 1) * 0.5
    py = ((flow[..., 1] + 1) * h - 1) * 0.5
    x0f, y0f = torch.floor(px), torch.floor(py)
    side = 2 * radius + 2
    outside = (~(torch.isfinite(px) & torch.isfinite(py)) | (x0f - radius > w - 1)
               | (x0f - radius + side - 1 < 0) | (y0f - radius > h - 1) | (y0f - radius + side - 1 < 0))
    zero = torch.zeros_like(px)
    x0 = torch.where(outside, zero, x0f).to(torch.int64) - radius
    y0 = torch.where(outside, zero, y0f).to(torch.int64) - radius
    x0, y0 = torch.where(outside, 0, x0), torch.where(outside, 0, y0)
    fx = torch.where(outside, zero, px - x0f)
    fy = torch.where(outside, zero, py - y0f)
    return x0, y0, fx, fy, outside


def _tiles(x: Tensor, tile: tuple[int, int], fill) -> Tensor:
    """(B, G1, G2) → (B, T1, T2, ty·tx): the cells of each tile, the grid
    padded with `fill` to whole tiles."""
    b, g1, g2 = x.shape
    ty, tx = tile
    t1, t2 = -(-g1 // ty), -(-g2 // tx)
    x = torch.nn.functional.pad(x, (0, t2 * tx - g2, 0, t1 * ty - g1), value=fill)
    return x.reshape(b, t1, ty, t2, tx).permute(0, 1, 3, 2, 4).reshape(b, t1, t2, ty * tx)


def corr_tile_boxes(flow: Tensor, h: int, w: int, radius: int, tile: tuple[int, int],
                    box: tuple[int, int]) -> tuple[Tensor, Tensor]:
    """The kernels' staging decision for (B, G1, G2, 2) flow on an h × w map:
    for each tile of `tile` (rows, columns) cells, the union's corner (B, T1,
    T2, 2) int64 xy (the least patch base of its cells whose window meets
    the map; 0 where none does) and whether the union fits `box` (rows,
    columns) of pixels, (B, T1, T2) bool. Cells outside widen nothing."""
    x0, y0, _, _, outside = _corr_windows(flow, h, w, radius)
    inside = _tiles(~outside, tile, False)
    big = 1 << 40
    lo_x = torch.where(inside, _tiles(x0, tile, 0), big).amin(-1)
    hi_x = torch.where(inside, _tiles(x0, tile, 0), -big).amax(-1)
    lo_y = torch.where(inside, _tiles(y0, tile, 0), big).amin(-1)
    hi_y = torch.where(inside, _tiles(y0, tile, 0), -big).amax(-1)
    win = 2 * radius + 2
    any_in = inside.any(-1)
    staged = any_in & (hi_x - lo_x + win <= box[1]) & (hi_y - lo_y + win <= box[0])
    corner = torch.stack([torch.where(any_in, lo_x, 0), torch.where(any_in, lo_y, 0)], -1)
    return corner, staged


def _tiled_patches(target: Tensor, flow: Tensor, radius: int, tile: tuple[int, int],
                   box: tuple[int, int]):
    """Each cell's (2r+2)² patch (N, win, win, C) as the kernels fetch it: a
    tile whose union fits the box is staged (the box cut from the map at the
    union's corner, zeros off the map) and its cells index into the box; the
    cells of other tiles read the map, zeros off it; cells outside get zeros
    (and so give zeros). Also fx, fy (N, 1, 1)."""
    b, g1, g2, _ = flow.shape
    _, h, w, c = target.shape
    win = 2 * radius + 2
    x0, y0, fx, fy, outside = _corr_windows(flow, h, w, radius)
    corner, staged = corr_tile_boxes(flow, h, w, radius, tile, box)
    pad = max(box) + win
    tp = torch.nn.functional.pad(target, (0, 0, pad, pad, pad, pad))
    dev = target.device
    ar = torch.arange(win, device=dev)

    # the staged boxes, one for each tile that fits
    sb, s1, s2 = staged.nonzero(as_tuple=True)
    cx, cy = corner[sb, s1, s2, 0] + pad, corner[sb, s1, s2, 1] + pad
    boxes = tp[sb[:, None, None], cy[:, None, None] + torch.arange(box[0], device=dev)[:, None],
               cx[:, None, None] + torch.arange(box[1], device=dev)]
    row = torch.full(staged.shape, -1, dtype=torch.int64, device=dev)
    row[sb, s1, s2] = torch.arange(len(sb), device=dev)

    gy = torch.arange(g1, device=dev)[:, None].expand(g1, g2)
    gx = torch.arange(g2, device=dev)[None, :].expand(g1, g2)
    bi = torch.arange(b, device=dev)[:, None, None].expand(b, g1, g2)
    cell_row = row[bi, gy // tile[0], gx // tile[1]]  # (B, G1, G2): the cell's box, or -1
    patches = target.new_zeros((b, g1, g2, win, win, c))
    from_box = ~outside & (cell_row >= 0)
    from_map = ~outside & (cell_row < 0)
    if from_box.any():
        r = cell_row[from_box]
        oy = y0[from_box] - corner[bi, gy // tile[0], gx // tile[1]][..., 1][from_box]
        ox = x0[from_box] - corner[bi, gy // tile[0], gx // tile[1]][..., 0][from_box]
        if (oy < 0).any() or (ox < 0).any() or (oy + win > box[0]).any() or (ox + win > box[1]).any():
            raise AssertionError("a staged cell's patch leaves its tile's box")
        patches[from_box] = boxes[r[:, None, None], (oy[:, None] + ar)[:, :, None], (ox[:, None] + ar)[:, None, :]]
    if from_map.any():
        patches[from_map] = tp[bi[from_map][:, None, None], (y0[from_map][:, None] + pad + ar)[:, :, None],
                               (x0[from_map][:, None] + pad + ar)[:, None, :]]
    n = b * g1 * g2
    return patches.reshape(n, win, win, c), fx.reshape(n, 1, 1), fy.reshape(n, 1, 1)


def local_corr_tiled_plain(query: Tensor, target: Tensor, flow: Tensor, radius: int,
                           tile: tuple[int, int], box: tuple[int, int]) -> Tensor:
    """K2's schedule in PyTorch: `_local_correlation_patch` on the patches
    of `_tiled_patches`."""
    return _local_correlation_patch(query, target, flow, radius,
                                    _tiled_patches(target, flow, radius, tile, box))


def local_corr_dq_tiled_plain(g: Tensor, target: Tensor, flow: Tensor, radius: int,
                              tile: tuple[int, int], box: tuple[int, int]) -> Tensor:
    """K3's schedule in PyTorch: `local_corr_dq_plain` on the patches of
    `_tiled_patches`."""
    return local_corr_dq_plain(g, target, flow, radius, _tiled_patches(target, flow, radius, tile, box))


def pad_channels(x: Tensor) -> Tensor:
    """x (..., C) zero-padded along C to a whole number of 16-byte vectors
    (TMA stages the target in them, the kernels read 16-byte loads),
    contiguous. Zero channels add nothing to a dot, so K2 and K3 on padded
    query and target compute the function at C, with the caller's 1/√C."""
    c = x.shape[-1]
    vec = 16 // x.element_size()
    width = -(-c // vec) * vec
    return torch.nn.functional.pad(x, (0, width - c)).contiguous() if width != c else x.contiguous()


class _LocalCorrelationCUDA(torch.autograd.Function):
    """K2 forward, K3 backward, on channels padded by `pad_channels` with the
    scale of the caller's C. The gradient goes to the query alone."""

    @staticmethod
    def forward(ctx, query: Tensor, target: Tensor, flow: Tensor, radius: int) -> Tensor:
        c = query.shape[-1]
        target = pad_channels(target)
        flow = flow.float().contiguous()
        ctx.save_for_backward(target, flow)
        ctx.radius, ctx.channels = radius, c
        return kernels.local_corr(pad_channels(query), target, flow, radius, scale=1.0 / math.sqrt(c))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad: Tensor):
        target, flow = ctx.saved_tensors
        # the incoming gradient is a slice of a concatenation's, cast from the
        # model dtype: K3 takes it float32 and contiguous
        dq = kernels.local_corr_bwd(grad.float().contiguous(), target, flow, ctx.radius,
                                    scale=1.0 / math.sqrt(ctx.channels))
        return dq[..., :ctx.channels], None, None, None


def local_correlation(query: Tensor, target: Tensor, flow: Tensor, radius: int) -> Tensor:
    """(B, G, G, C) query, (B, H, W, C) target, (B, G, G, 2) flow →
    (B, G, G, (2r+1)²) float32, differentiable in the query only. On CUDA,
    query and target share one storage dtype (float32 or bf16), accumulate
    in float32, and take any C (`pad_channels`)."""
    if query.is_cuda:
        return _LocalCorrelationCUDA.apply(query, target, flow, radius)
    return _local_correlation_patch(query, target.detach(), flow.detach(), radius)
