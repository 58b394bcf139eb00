"""Driver of the `homography_vitreg` kind: the `homography` driver's calls,
window, sample and three checks, on a DINOv2 backbone with registers, and
a fourth number that holds the backbone itself.

The weights and the reference differ: the backbone is DINOv2's own seeded
draw (`portbench/weights_vitreg.py`: registers and the fused SwiGLU FFN,
which JAX's draw of `portbench/weights.py` does not make), and the
reference is `reference/matcher_registers.RegisterReference`, whose ViT is
`reference/vit_registers.py`.

The fourth number: a fault confined to the ViT (its products on fp8
operands, its register tokens left out) moves none of the three, because
the refiners re-derive the warp from the FPN's features wherever the
coarse match stays put (`portbench/control_vit.py`). So the program's ViT
tokens of pass 1 in the sampled calls are kept too, and compared:

  vit_rel   for each pair, the relative RMS distance between the
            program's patch tokens of its two images and the reference
            ViT's on the reference's own pass-1 input; then the median
            over the pairs.
"""

from __future__ import annotations

from pathlib import Path

import torch

from portbench import spec
from portbench.reference import numerics
from portbench.reference.config import ModelConfig as ReferenceConfig
from portbench.reference.matcher_registers import RegisterReference
from portbench.reference.vit_registers import ViTConfig
from portbench.weights import read_head
from portbench.weights_vitreg import vit_state

_BASE = spec.driver("homography", Path(__file__).resolve().parents[2])
CHECKS = (*_BASE.CHECKS, "vit_rel")


class Driver(_BASE.Driver):
    """One run of a `homography_vitreg` cell on `device`."""

    def start(self, seed: int) -> None:
        super().start(seed)
        self.vit_tokens: dict[int, torch.Tensor] = {}

    def weights(self):
        """The seeded register ViT and the head on the host; the head file's
        k/v standardization has to be the configuration's. A program whose
        ViT has no register tokens is refused before the draw."""
        from gfnet_tpu_torch.config import DinoConfig

        if not hasattr(DinoConfig(), "num_register_tokens"):
            raise NotImplementedError("this program's ViT takes no register tokens")
        w, dino = self.config["weights"], self.config["dino_cfg"]
        head, kv_norm = read_head(self.cell.root / w["head"], w["head_sha256"])
        if kv_norm != dino["decoder_cfg"]["kv_norm"]:
            raise ValueError("the head's k/v standardization is not the configuration's")
        return vit_state(dino), head

    def setup(self) -> None:
        super().setup()

        def keep(module, args, out):  # the first ViT call of a sampled call is its pass 1
            if self.capturing and self.current not in self.vit_tokens:
                self.vit_tokens[self.current] = out.detach().clone()

        self.matcher.vit.register_forward_hook(keep)

    def reference(self) -> RegisterReference:
        return RegisterReference(ReferenceConfig.from_dict(self.config), ViTConfig.from_dict(self.config["dino_cfg"]),
                                 self.vit_state, self.head_state, self.device)

    # ------------------------------------------------------------------ check
    def _reference_tokens(self, ref: RegisterReference, i: int) -> torch.Tensor:
        """The reference ViT's pass-1 tokens of call i's pairs, stacked as
        the program stacks them: (2·batch, N, D), the a side first."""
        rows, size = self._rows(i), ref.cfg.initial_res
        a, b = (ref._prep(t[rows].float().to(ref.device), size, "bicubic") for t in (self.a, self.b))
        return ref.vit(torch.cat([a, b]))

    def program_outputs(self) -> dict:
        """{call: (warp, certainty, H, pass-1 ViT tokens)} of the sampled
        calls that ran."""
        return {i: (*out, self.vit_tokens[i]) for i, out in super().program_outputs().items()
                if i in self.vit_tokens}

    def control_outputs(self, ref: RegisterReference) -> dict:
        """The `homography` control, with the lowered reference's tokens."""
        out = super().control_outputs(ref)
        with numerics.lowered():
            return {i: (*o, self._reference_tokens(ref, i)) for i, o in out.items()}

    def check(self, outputs: dict, ref: RegisterReference) -> dict:
        """The three numbers of `homography` and `vit_rel`, each beside the
        configuration's limit."""
        checks = super().check(outputs, ref)
        limit = self.config["limits"]["vit_rel"]
        if not outputs:
            return {**checks, "vit_rel": {"value": float("inf"), "limit": limit}}
        rel = []
        for i in sorted(outputs):
            mine, theirs = outputs[i][3].float(), self._reference_tokens(ref, i)
            mine, theirs = (torch.stack(t.chunk(2)).transpose(0, 1).flatten(1) for t in (mine, theirs))
            rel.append(torch.linalg.norm(mine - theirs, dim=1) / torch.linalg.norm(theirs, dim=1))
        rel = torch.cat(rel)
        self.pair_readings["vit_rel"] = rel.tolist()
        return {**checks, "vit_rel": {"value": float(torch.quantile(rel, 0.5)), "limit": limit}}
