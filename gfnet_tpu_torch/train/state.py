"""Train state + optimizer, replicating the reference's training dynamics.

Counterpart of `gfnet_tpu/train/state.py`. Reference recipe (`train.py:107-119`,
`trainer/train.py:29-64`): AdamW, weight decay 0.01 on every parameter,
lr = global_batch * 1e-4 / 8, cosine annealing stepped once per k-step chunk
(k = 25000 / global_batch), global grad-norm clip at 0.01 applied before the
optimizer step. No loss scaling: compute runs in bf16, whose exponent range
is float32's.

The optimizer is `torch.optim.AdamW`, which computes optax's `adamw` update
(bias-corrected moments, decay decoupled and scaled by the learning rate).
The clip is written out here: optax scales by clip / max(norm, clip), where
`torch.nn.utils.clip_grad_norm_` scales by clip / (norm + 1e-6), which
differs by 1e-4 relative at the recipe's clip of 0.01. The learning rate of
an update is the schedule at the step count before it, as in optax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable

import torch
import torch.nn as nn

from gfnet_tpu_torch.config import TrainConfig

Tensor = torch.Tensor


def make_lr_schedule(cfg: TrainConfig, global_batch: int) -> Callable[[int], float]:
    """Cosine annealing over chunk epochs (ref `train.py:111`,
    `trainer/train.py:63`: the scheduler steps once per k-step chunk)."""
    base_lr = cfg.lr_per_sample * global_batch
    k = max(cfg.ckpt_every_pairs // global_batch, 1)
    total_epochs = max(cfg.total_pairs // (k * global_batch), 1)

    def schedule(step: int) -> float:
        epoch = min(step // k, total_epochs)
        return base_lr * 0.5 * (1 + math.cos(math.pi * epoch / total_epochs))

    return schedule


def global_norm(tensors: Iterable[Tensor]) -> Tensor:
    """sqrt of the sum of squares over all tensors, in float32."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def clip_by_global_norm_(grads: list[Tensor], max_norm: float) -> None:
    """Scale the gradients in place by max_norm / max(norm, max_norm)."""
    if grads:
        scale = max_norm / global_norm(grads).clamp_min(max_norm)
        for g in grads:
            g.mul_(scale)


@dataclasses.dataclass
class TrainState:
    """Step count, the trainable head (parameters and BatchNorm running
    statistics) and its optimizer. The frozen ViT is not part of it."""

    step: int
    head: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    grad_clip_norm: float

    def apply_gradients(self) -> None:
        """Global-norm clip of the head's `.grad`s, then one AdamW update at
        the schedule's rate for the current step."""
        params = [p for p in self.head.parameters() if p.grad is not None]
        clip_by_global_norm_([p.grad for p in params], self.grad_clip_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1


def create_train_state(head: nn.Module, cfg: TrainConfig, global_batch: int) -> TrainState:
    """A train state around `head`, whose parameters become trainable."""
    head.requires_grad_(True)
    schedule = make_lr_schedule(cfg, global_batch)
    optimizer = torch.optim.AdamW(head.parameters(), lr=schedule(0), betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=cfg.weight_decay)
    return TrainState(step=0, head=head, optimizer=optimizer, schedule=schedule,
                      grad_clip_norm=cfg.grad_clip_norm)
