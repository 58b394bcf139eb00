"""The training step.

Counterpart of `gfnet_tpu/train/step.py`: forward (frozen ViT in the model
dtype without gradient), multi-scale robust loss, backward, gradient
telemetry and the per-module stabilizers, global-norm clip, AdamW update and
the BatchNorm running-statistics refresh. The training forward runs
symmetric=False like the reference's (`trainer/train.py:31`).

With a `mesh` (`parallel.mesh.Mesh`) each rank steps on its rows of the
global batch, and the step is the JAX step's over the sharded batch: the
BatchNorm moments and the loss's means are the global batch's (all-reduced
in the forward), and the gradients are combined over the ranks before the
telemetry, the stabilizers, the clip and AdamW, so every rank sees what the
JAX step sees and takes the same update. The combine is one all-reduce of
all gradients flattened into a buffer, divided by the number of ranks:
the backward of the forward's all-reduces already sums the ranks'
gradients of the replicated loss into each rank's share, so each rank holds
`size` times its share of the global gradient (`Mesh.all_reduce`).
`DistributedDataParallel` would average too, but it starts its reductions
inside the backward and over buckets of its own, where the order against
the forward's own collectives in recomputed (checkpointed) blocks is not
this code's to choose. With `fsdp_vit` the frozen ViT is sharded over the
ranks (`parallel.mesh.shard_params`): each block all-gathers its weights
before it runs and frees them after, and the step is otherwise unchanged.

Modules are named as the JAX package's top-level parameter groups, so
`freeze`, `module_clip` and `module_spike_zero` take the same names in both:
crossview, encoder, fpn_decoder, merge_layer, refiners_16 ... refiners_1.

Spans (`utils/profiling.py`): `train.step` around the step, and in it
`train.forward` (the ViT, the head and the loss), `train.backward` and
`train.update` (from the gradients to `state.apply_gradients()`).
"""

from __future__ import annotations

import os
from typing import Any, Callable

import torch
import torch.nn as nn

from gfnet_tpu_torch.matcher.api import imagenet_normalize
from gfnet_tpu_torch.models.common import sync_batch_norms
from gfnet_tpu_torch.parallel.mesh import shard_params
from gfnet_tpu_torch.train.loss import RobustLoss
from gfnet_tpu_torch.train.state import TrainState, global_norm
from gfnet_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def head_modules(head: nn.Module) -> dict[str, nn.Module]:
    """The head's top-level modules under the JAX package's group names."""
    groups = {"crossview": head.dino_decoder, "encoder": head.encoder,
              "fpn_decoder": head.decoder, "merge_layer": head.merge_layer}
    groups.update({f"refiners_{scale}": m for scale, m in head.conv_refiner.items()})
    return groups


def combine_gradients(params: list, mesh) -> None:
    """Replace each parameter's `.grad` by its mean over the ranks of
    `mesh`, in one all-reduce of the gradients flattened into one buffer."""
    if mesh is None:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.all_reduce_(flat).div_(mesh.size)
    torch._foreach_copy_(grads, [part.view_as(g) for g, part in zip(grads, flat.split([g.numel() for g in grads]))])


def make_train_step(
    matcher,
    loss: RobustLoss,
    mesh=None,
    symmetric: bool = False,
    fsdp_vit: bool = False,
    fsdp_min_size: int = 2**16,
    freeze: tuple[str, ...] = (),
    module_clip: dict[str, float] | None = None,
    module_spike_zero: dict[str, float] | None = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Build the train step.

    matcher: GFNetMatcher (provides the frozen ViT, the device and dtype).
    mesh: the ranks the global batch is split over, or None for one process.
    fsdp_vit: shard the matcher's frozen ViT over the mesh, in place
    (`parallel.mesh.shard_params` with `fsdp_min_size`): the matcher then
    runs the sharded ViT, every rank together. Needs a mesh.
    Returns step(state, batch) -> (state, metrics). batch is a dict with
    im_A/im_B (B, H, W, 3), imagenet-normalized floats or raw uint8, and
    H_s2t (B, 3, 3), as numpy arrays or tensors: this rank's rows under a
    mesh (`parallel.mesh.shard_batch`). The state is updated in
    place and returned; metrics are 0-dim tensors on the device. The head is
    in train mode during the step and back in eval mode after it, so a
    matcher that shares the head keeps matching with running statistics.
    """
    if fsdp_vit:
        if mesh is None:
            raise ValueError("fsdp_vit shards the ViT over a mesh: pass mesh=")
        shard_params(mesh, matcher.vit, fsdp_min_size)
    vit, device = matcher.vit, matcher.device

    @span("train.step")
    def step_fn(state: TrainState, batch: dict[str, Any]) -> tuple[TrainState, dict]:
        head = state.head
        groups = {k: list(m.parameters()) for k, m in head_modules(head).items()}
        # a typo'd freeze/module_clip name would silently do nothing and
        # re-admit the exploding-gradient regime the flags exist to prevent
        unknown = (set(freeze) | set(module_clip or ()) | set(module_spike_zero or ())) - set(groups)
        if unknown:
            raise ValueError(f"freeze/module_clip names not in the head: {sorted(unknown)}")
        head.train()
        try:
            head.zero_grad(set_to_none=True)
            with sync_batch_norms(head, mesh):
                with span("train.forward"):
                    im_a, im_b, H_s2t = (torch.as_tensor(batch[k]).to(device) for k in ("im_A", "im_B", "H_s2t"))
                    # uint8 transport: loaders may ship raw 8-bit HWC images (4x less
                    # host->device traffic); the imagenet normalization happens here
                    if im_a.dtype == torch.uint8:
                        im_a, im_b = (imagenet_normalize(t.float() / 255.0) for t in (im_a, im_b))
                    with torch.no_grad():
                        tokens = vit(torch.cat([im_a, im_b], dim=0))
                    corresps = head(im_a, im_b, tokens, symmetric=symmetric)
                    total, metrics = loss(corresps, H_s2t.float(), tuple(im_a.shape[1:3]),
                                          tuple(im_b.shape[1:3]), mesh=mesh)
                with span("train.backward"):
                    total.backward()
        finally:
            head.eval()
        metrics = {k: v.detach() for k, v in metrics.items()}

        with torch.no_grad(), span("train.update"):
            for p in head.parameters():  # a leaf the loss did not reach counts as zero
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            combine_gradients(list(head.parameters()), mesh)
            grads = {k: [p.grad for p in ps] for k, ps in groups.items()}
            # NaN/Inf-gradient telemetry (ref `trainer/train.py:21-25`), from
            # the gradients before freeze, so blowups inside a frozen module
            # stay observable
            metrics["nonfinite_grad_leaves"] = sum(
                (~torch.isfinite(g)).any().to(torch.int32) for gs in grads.values() for g in gs)
            breakdown = os.environ.get("GFNET_GRAD_BREAKDOWN") == "1"
            if breakdown:  # raw per-module norms, before spike-zero/clip/freeze
                for k, gs in grads.items():
                    metrics[f"gnorm_raw/{k}"] = global_norm(gs)
            for k, thresh in (module_spike_zero or {}).items():
                # outlier-step rejection: above its threshold a module's
                # gradient is zeroed for this step (clipping would still push
                # an lr-sized step in the garbage direction through Adam)
                keep = (global_norm(grads[k]) <= thresh).to(torch.float32)
                for g in grads[k]:
                    g.mul_(keep)
            for k, cap in (module_clip or {}).items():
                # per-module clip, before the recipe's global clip
                scale = (cap / (global_norm(grads[k]) + 1e-16)).clamp_max(1.0)
                for g in grads[k]:
                    g.mul_(scale)
            for k in freeze:
                # zeroed, not skipped: the global clip then reflects only the
                # learners; AdamW's decoupled decay still shrinks the frozen
                # parameters by lr*wd per step, as in the JAX step
                for g in grads[k]:
                    g.zero_()
            every = [g for gs in grads.values() for g in gs]
            metrics["grad_norm"] = global_norm(every)
            metrics["param_norm"] = global_norm(head.parameters())
            if breakdown:
                for k, gs in grads.items():
                    metrics[f"gnorm/{k}"] = global_norm(gs)
            state.apply_gradients()
        return state, metrics

    return step_fn
