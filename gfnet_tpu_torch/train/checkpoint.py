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
"""

from __future__ import annotations

import os
import re

import torch

from gfnet_tpu_torch.train.state import TrainState

_STEP_RE = re.compile(r"^step_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, root: str, name: str, keep: int = 2, mesh=None):
        self.dir = os.path.abspath(os.path.join(root, name))
        self.keep = max(1, keep)
        self.mesh = mesh
        os.makedirs(self.dir, exist_ok=True)

    def _step_files(self) -> list[tuple[int, str]]:
        out = []
        for entry in os.listdir(self.dir):
            m = _STEP_RE.match(entry)
            if m and os.path.isfile(os.path.join(self.dir, entry)):
                out.append((int(m.group(1)), os.path.join(self.dir, entry)))
        return sorted(out)

    @property
    def latest_path(self) -> str | None:
        """Newest committed checkpoint file, or None."""
        files = self._step_files()
        return files[-1][1] if files else None

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
        device = next(state.head.parameters()).device
        payload = torch.load(path, map_location=device, weights_only=True)
        state.head.load_state_dict(payload["head"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state
