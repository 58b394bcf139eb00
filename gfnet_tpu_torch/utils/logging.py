"""Training telemetry: wandb-optional metric logging + JSONL fallback.

Covers the reference's observability surface (SURVEY.md §5): per-scale loss
components, pck@0.5, grad/param norms, LR — logged to wandb when available
(project "GFNet" like `train.py:30-33`), always mirrored to a local JSONL so
runs are inspectable without external services. An own copy of the JAX
package's `utils/logging.py`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

try:
    import wandb  # type: ignore

    _WANDB = True
except Exception:
    _WANDB = False


class MetricLogger:
    def __init__(
        self,
        enabled: bool = True,
        use_wandb: bool | None = None,
        project: str = "GFNet-Torch",
        name: str | None = None,
        jsonl_path: str | None = "workspace/metrics.jsonl",
    ):
        self.enabled = enabled
        self.use_wandb = (_WANDB and os.environ.get("WANDB_MODE") != "disabled") \
            if use_wandb is None else use_wandb
        self.jsonl_path = jsonl_path
        if enabled and self.use_wandb:
            try:
                wandb.init(project=project, name=name, reinit=False)
            except Exception:
                self.use_wandb = False
        if enabled and jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)

    def log(self, metrics: dict[str, Any], step: int) -> None:
        if not self.enabled:
            return
        if self.use_wandb:
            try:
                wandb.log(metrics, step=step)
            except Exception:
                pass
        if self.jsonl_path:
            rec = {"step": step, "time": time.time(), **metrics}
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        scalars = {k: v for k, v in list(metrics.items())[:4]}
        print(f"step {step}: " + " ".join(f"{k}={v:.5g}" for k, v in scalars.items()))
