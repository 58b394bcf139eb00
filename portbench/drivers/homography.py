"""Driver of the `homography` kind: back-to-back homography calls on
batches of `batch` synthetic pairs, one caller, closed loop.

A call is what a user of the port makes: with `batch` 1,
`GFNetMatcher.estimate_homography(a, b, num_matches, key=k)`, else
`estimate_homography_batched` on `batch` pairs; the homographies are read
back to the host, which ends the call. Call i takes the pool's pairs
[i·batch, (i+1)·batch) modulo the pool, and the key `fold_in(PRNGKey(seed), i)`.

For the check, the program's warp and certainty of the calls in a sample
drawn from the seed are kept as its sampling takes them (the matcher's
`_sample_solve`). Once the window has closed and the program is freed, the
plain reference (float32, TF32 off) matches the same pairs and solves the
kept warps under the same keys. Three numbers are compared:

  warp_px   the program's warp against the reference's: for each pair the
            median distance, in pixels of the input, over the cells the
            reference is certain of (certainty above 0.5); then the 75th
            percentile over the pairs (the ViT, the decoder, the FPN, the
            correlations, the refiners and the stitch);
  cert_gap  for each pair the mean |certainty - the reference's|; then the
            median over the pairs;
  solve_px  the largest mean corner distance, in pixels, between the
            program's homography and the reference's solve of the
            program's own warp and certainty under the call's key (the
            draws, Gumbel top-k, KDE, RANSAC and IRLS).

The medians and percentiles keep a pair or two of the sample whose
matching falls, in bf16, into another of two near-equal solutions over
part of the image from setting the number alone: those parts read tens of
pixels in sound runs and would let no limit part sound runs from the
control; a fault in many pairs, or everywhere, still moves them.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic
from portbench.reference import keys as K
from portbench.reference import numerics
from portbench.reference.config import ModelConfig as ReferenceConfig
from portbench.reference.matcher import Reference
from portbench.reference.ops import transform_points
from portbench.weights import read_head, vit_state

CHECKS = ("warp_px", "cert_gap", "solve_px")
CHECK_BLOCK = 8  # pairs the reference matches at once
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def corner_distance(H1: torch.Tensor, H2: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Mean distance between the image corners under H1 and under H2 (B,)."""
    corners = torch.tensor([[0.0, 0.0], [0.0, h - 1], [w - 1, 0.0], [w - 1, h - 1]], dtype=torch.float64)
    p1 = transform_points(H1.double().cpu(), corners.expand(H1.shape[0], 4, 2))
    p2 = transform_points(H2.double().cpu(), corners.expand(H2.shape[0], 4, 2))
    return torch.linalg.norm(p1 - p2, dim=-1).mean(-1)


class Driver:
    """One run of a `homography` cell on `device`."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.device = cell, torch.device(device)
        self.mix, self.config = cell.mix, cell.config
        self.batch = int(self.mix["batch"])
        self.start(seed)

    def start(self, seed: int) -> None:
        """Take up `seed`: its keys, its sample of calls to check, and (once
        the program is set up) its pool of pairs."""
        self.seed = seed
        self.captured: dict[int, tuple] = {}
        self.results: dict[int, torch.Tensor] = {}
        self.capturing = False
        base = K.prng_key(seed)
        self.keys = np.stack(K.threefry2x32_np(base, np.zeros(1 << 14, np.uint32),
                                               np.arange(1 << 14, dtype=np.uint32)), axis=-1)
        self.warm_key = K.fold_in(K.split(base)[1], 0)
        rng = np.random.default_rng([seed, 1])
        self.sample = set(int(i) for i in rng.choice(int(self.mix["check_among"]),
                                                     int(self.mix["check_calls"]), replace=False))
        if hasattr(self, "matcher"):
            self.a, self.b = traffic.make_pool(seed, int(self.mix["pool"]), self.mix, self.device)

    # ---------------------------------------------------------------- set-up
    def weights(self):
        """The ViT and head state dicts on the host; the head file's k/v
        standardization has to be the configuration's."""
        w = self.config["weights"]
        dino = {k: self.config["dino_cfg"][k] for k in
                ("d_model", "depth", "num_heads", "patch_size", "pos_embed_size", "mlp_ratio", "init_values")}
        vit = vit_state(dino)
        head, kv_norm = read_head(self.cell.root / w["head"], w["head_sha256"])
        if kv_norm != self.config["dino_cfg"]["decoder_cfg"]["kv_norm"]:
            raise ValueError("the head's k/v standardization is not the configuration's")
        return vit, head

    def setup(self) -> None:
        from gfnet_tpu_torch.config import ModelConfig
        from gfnet_tpu_torch.matcher import GFNetMatcher

        self.vit_state, self.head_state = self.weights()
        cfg = ModelConfig.from_dict(self.config)
        self.matcher = GFNetMatcher(cfg, device=self.device, dtype=DTYPES[self.config["dtype"]],
                                    vit_state=self.vit_state, head_state=self.head_state)
        self.a, self.b = traffic.make_pool(self.seed, int(self.mix["pool"]), self.mix, self.device)
        original = self.matcher._sample_solve

        def sample_solve(warp, certainty, *args):
            if self.capturing:
                self.captured[self.current] = (warp.clone(), certainty.clone())
            return original(warp, certainty, *args)

        self.matcher._sample_solve = sample_solve
        for _ in range(int(self.mix["warmup_calls"])):
            self._run(0, self.warm_key)

    def layers(self) -> dict:
        """The program's modules that the traced run puts spans around."""
        m = self.matcher
        out = {"vit": m.vit, "head": m.head}
        out.update({f"refiner.{s}": r for s, r in m.head.conv_refiner.items()})
        return out

    # ------------------------------------------------------------------ calls
    def _rows(self, i: int) -> slice:
        s = (i * self.batch) % self.a.shape[0]
        return slice(s, s + self.batch)

    def _run(self, i: int, key) -> torch.Tensor:
        rows, num = self._rows(i), int(self.mix["num_matches"])
        if self.batch == 1:
            H = self.matcher.estimate_homography(self.a[rows.start], self.b[rows.start], num, key=key)[None]
        else:
            H = self.matcher.estimate_homography_batched(self.a[rows], self.b[rows], num, key=key)
        return H.cpu()

    def key(self, i: int) -> np.ndarray:
        return self.keys[i] if i < len(self.keys) else K.fold_in(K.prng_key(self.seed), i)

    def call(self, i: int) -> int:
        """Call i; returns the pairs it completed (a homography not finite
        is not completed)."""
        self.current, self.capturing = i, i in self.sample
        H = self._run(i, self.key(i))
        self.capturing = False
        if i in self.sample:
            self.results[i] = H
        return int(torch.isfinite(H).all(-1).all(-1).sum())

    def pairs_per_call(self) -> int:
        return self.batch

    def release(self) -> None:
        """Free the program's state."""
        del self.matcher
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ check
    def program_outputs(self) -> dict:
        """{call: (warp, certainty, H)} of the sampled calls that ran."""
        return {i: (*self.captured[i], self.results[i]) for i in sorted(self.results) if i in self.captured}

    def control_outputs(self, ref: Reference) -> dict:
        """{call: (warp, certainty, H)} of the sampled calls, answered by the
        reference one step of precision lower (`numerics.lowered`): the
        control of `check`."""
        res, num, out = self.mix["res"], int(self.mix["num_matches"]), {}
        for i in sorted(self.sample):
            rows = self._rows(i)
            with numerics.lowered():
                w, c = ref.match(self.a[rows], self.b[rows])
                H = ref.sample_solve(w, c, num, (res, res), (res, res), K.split(self.key(i), self.batch))
            out[i] = (w, c, H.cpu())
        return out

    def reference(self) -> Reference:
        return Reference(ReferenceConfig.from_dict(self.config), self.vit_state, self.head_state, self.device)

    def check(self, outputs: dict, ref: Reference) -> dict:
        """The three numbers of `outputs` ({call: (warp, certainty, H)})
        against `ref`, each beside the configuration's limit."""
        limits = self.config["limits"]
        res = self.mix["res"]
        if not outputs:
            return {name: {"value": float("inf"), "limit": limits[name]} for name in CHECKS}
        calls = sorted(outputs)
        idx = [j for i in calls for j in range(self._rows(i).start, self._rows(i).stop)]
        warp_p = torch.cat([outputs[i][0] for i in calls]).float().to(self.device)
        cert_p = torch.cat([outputs[i][1] for i in calls]).float().to(self.device)
        H_p = torch.cat([outputs[i][2] for i in calls])
        keys = np.concatenate([K.split(self.key(i), self.batch) for i in calls])
        block = CHECK_BLOCK
        warp_r, cert_r, H_r = [], [], []
        for s in range(0, len(idx), block):
            rows = idx[s:s + block]
            w, c = ref.match(self.a[rows], self.b[rows])
            warp_r.append(w)
            cert_r.append(c)
            H_r.append(ref.sample_solve(warp_p[s:s + block], cert_p[s:s + block], int(self.mix["num_matches"]),
                                        (res, res), (res, res), keys[s:s + block]).cpu())
        values = self._numbers(warp_p, cert_p, H_p, torch.cat(warp_r), torch.cat(cert_r), torch.cat(H_r), res)
        self.pair_readings = values.pop("pairs")
        return {name: {"value": values[name], "limit": limits[name]} for name in CHECKS}

    @staticmethod
    def _numbers(warp_p, cert_p, H_p, warp_r, cert_r, H_r, res: int) -> dict:
        scale = torch.tensor([(res - 1) / 2.0] * 4, device=warp_p.device)
        dist = torch.linalg.norm((warp_p - warp_r) * scale, dim=-1).flatten(1)
        certain = cert_r.flatten(1) > 0.5
        medians = torch.stack([torch.quantile(d[m] if m.any() else d, 0.5) for d, m in zip(dist, certain)])
        gaps = (cert_p - cert_r).abs().flatten(1).mean(1)
        corners = corner_distance(H_p, H_r, res, res).nan_to_num(float("inf"))
        return {"warp_px": float(torch.quantile(medians, 0.75)), "cert_gap": float(torch.quantile(gaps, 0.5)),
                "solve_px": float(corners.max()),
                "pairs": {"warp_px": medians.tolist(), "cert_gap": gaps.tolist(), "solve_px": corners.tolist()}}
