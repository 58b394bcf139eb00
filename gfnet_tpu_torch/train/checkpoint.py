"""Checkpoint and resume for the training loop.

Counterpart of `gfnet_tpu/train/checkpoint.py` with `torch.save` in place of
Orbax. The frozen ViT stays out of the checkpoint: only the head (parameters
and BatchNorm running statistics), the optimizer state and the step.

Under a mesh (`parallel.mesh.Mesh`) rank 0 writes and prunes, every rank
waits for it at a barrier, and every rank restores the same file.

Saves are crash-safe: each save is written under a temporary name and renamed
into a fresh versioned `step_<N>.pt`, so a partially written file never
carries a final name, and older versions are pruned only after the new one is
committed. A kill at any instant leaves the previous checkpoint restorable.

Auto-resume also takes the JAX package's checkpoints in the same directory:
its Orbax `step_<N>/` directories and its legacy un-versioned `latest`
(read by `utils/orbax.py`, without orbax). Restoring one fills the head's
parameters and running statistics, each parameter's AdamW step and moments
(optax's `opt_state/1/0/{count, mu, nu}`, laid out by the weight bridge) and
the step; the schedule's count (`opt_state/1/2/count`) must equal the step.
Saves stay `.pt`, and pruning removes only `.pt` files: the port never
deletes a JAX checkpoint.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from gfnet_tpu_torch.train.state import TrainState

_STEP_RE = re.compile(r"^step_(\d+)\.pt$")
_ORBAX_STEP_RE = re.compile(r"^step_(\d+)$")


class Checkpointer:
    def __init__(self, root: str, name: str, keep: int = 2, mesh=None):
        self.dir = os.path.abspath(os.path.join(root, name))
        self.keep = max(1, keep)
        self.mesh = mesh
        os.makedirs(self.dir, exist_ok=True)

    def _entries(self, pattern: re.Pattern, is_kind) -> list[tuple[int, str]]:
        """(step, path) of the directory's entries named by `pattern` that
        `is_kind` (os.path.isfile or isdir) accepts, by step."""
        out = []
        for entry in os.listdir(self.dir):
            m = pattern.match(entry)
            if m and is_kind(os.path.join(self.dir, entry)):
                out.append((int(m.group(1)), os.path.join(self.dir, entry)))
        return sorted(out)

    def _step_files(self) -> list[tuple[int, str]]:
        return self._entries(_STEP_RE, os.path.isfile)

    @property
    def latest_path(self) -> str | None:
        """Newest committed checkpoint: the highest step among the port's
        `step_<N>.pt` and the JAX package's `step_<N>/` directories (`.pt` on
        a tie), else JAX's legacy `latest` directory, else None."""
        # (step, 1) sorts a .pt after a directory of the same step
        found = ([(s, 1, p) for s, p in self._step_files()]
                 + [(s, 0, p) for s, p in self._entries(_ORBAX_STEP_RE, os.path.isdir)])
        if found:
            return max(found)[2]
        legacy = os.path.join(self.dir, "latest")
        return legacy if os.path.exists(legacy) else None

    def save(self, state: TrainState) -> None:
        if self.mesh is None or self.mesh.rank == 0:
            payload = {"step": state.step, "head": state.head.state_dict(),
                       "optimizer": state.optimizer.state_dict()}
            path = os.path.join(self.dir, f"step_{state.step:09d}.pt")
            tmp = f"{path}.tmp-{os.getpid()}"
            torch.save(payload, tmp)
            os.replace(tmp, path)
            # prune only after the new version is committed
            for _, old in self._step_files()[: -self.keep]:
                os.remove(old)
        if self.mesh is not None:
            self.mesh.barrier()

    def restore(self, state: TrainState) -> TrainState | None:
        """Load the newest checkpoint into `state` (in place) and return it,
        or None when there is none (ref `train.py:116`, auto-resume)."""
        path = self.latest_path
        if path is None:
            return None
        if os.path.isdir(path):
            return restore_orbax(state, path)
        device = next(state.head.parameters()).device
        payload = torch.load(path, map_location=device, weights_only=True)
        state.head.load_state_dict(payload["head"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state


def restore_orbax(state: TrainState, path: str) -> TrainState:
    """Fill `state` (in place) from the JAX trainer's Orbax checkpoint
    directory `path` (step, params, batch_stats, opt_state of
    `optax.chain(clip_by_global_norm, adamw(schedule))`) and return it."""
    from gfnet_tpu_torch.utils.convert import (flax_to_torch_head, flax_to_torch_head_moments,
                                               float32_tree)
    from gfnet_tpu_torch.utils.orbax import read_checkpoint

    tree = read_checkpoint(path)
    try:
        step = int(np.asarray(tree["step"]))
        adam = tree["opt_state"]["1"]["0"]
        count = int(np.asarray(adam["count"]))
        sched = int(np.asarray(tree["opt_state"]["1"]["2"]["count"]))
        params, stats = float32_tree(tree["params"]), float32_tree(tree["batch_stats"])
        mu, nu = float32_tree(adam["mu"]), float32_tree(adam["nu"])
    except KeyError as e:
        raise ValueError(f"{path}: no {e} in the checkpoint; the JAX trainer's step directory "
                         "holds step, params, batch_stats and opt_state "
                         "(clip_by_global_norm, adamw)") from None
    if sched != step:
        raise ValueError(f"{path}: the schedule's count opt_state/1/2/count = {sched} differs "
                         f"from step = {step}")
    head = state.head
    head.load_state_dict(flax_to_torch_head({"params": params, "batch_stats": stats}))
    exp_avg = flax_to_torch_head_moments(mu, stats)
    exp_avg_sq = flax_to_torch_head_moments(nu, stats)
    names = {id(p): n for n, p in head.named_parameters()}
    opt_sd = state.optimizer.state_dict()
    group_params = [p for g in state.optimizer.param_groups for p in g["params"]]
    new_state = {}
    for idx, p in zip([i for g in opt_sd["param_groups"] for i in g["params"]], group_params):
        name = names[id(p)]
        for what, moments in (("mu", exp_avg), ("nu", exp_avg_sq)):
            if name not in moments:
                raise ValueError(f"{path}: opt_state/1/0/{what} has no moment for {name}")
            if tuple(moments[name].shape) != tuple(p.shape):
                raise ValueError(f"{path}: opt_state/1/0/{what} for {name} has shape "
                                 f"{tuple(moments[name].shape)}, the parameter {tuple(p.shape)}")
        new_state[idx] = {"step": torch.tensor(float(count)), "exp_avg": exp_avg[name],
                          "exp_avg_sq": exp_avg_sq[name]}
    opt_sd["state"] = new_state
    state.optimizer.load_state_dict(opt_sd)
    state.step = step
    return state
