"""The backbone's own control of `correct`: a fault in the reference's ViT alone.

    python3 portbench/control_vit.py --workload vitg-batch-b8 --seeds 1,2,3 [--faults fp8,no_registers]

`control.py` lowers the whole reference at once, so a cell whose check
fails it might still miss a fault that stays inside the backbone. Here,
for each seed and fault, the calls that a run of the seed samples are
answered by the plain reference with the fault in its ViT only (the head,
sampling and solve in float32 as they are) and checked against the float32
reference as a run checks the program. Faults:

- `fp8`: the ViT's products on fp8 operands (`numerics.lowered()` inside
  the ViT's forward alone);
- `no_registers`: the ViT run without its register tokens;
- `registers_out`: the ViT dropping cls alone from its output, so the
  register tokens come out as the first patches and the last patches are
  lost (the slice of a ViT without registers).

Set-up is made once. Prints one JSON line a seed and fault, then one with
each fault's smallest reading of each number beside the configuration's
limit. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FAULTS = ("fp8", "no_registers", "registers_out")


@contextlib.contextmanager
def fault(vit, name: str):
    """Within the block, the reference ViT `vit` runs with fault `name`."""
    import torch

    from portbench.reference import numerics

    if name == "fp8":
        forward = vit.forward

        def lowered_forward(x):
            with numerics.lowered():
                return forward(x)

        vit.forward = lowered_forward
        try:
            yield
        finally:
            del vit.forward
    elif name == "no_registers":
        cfg = vit.cfg
        if not cfg.num_register_tokens:
            raise ValueError("this ViT has no register tokens to leave out")
        vit.cfg = dataclasses.replace(cfg, num_register_tokens=0)
        try:
            yield
        finally:
            vit.cfg = cfg
    elif name == "registers_out":
        r, norm = vit.cfg.num_register_tokens, vit.norm.forward
        if not r:
            raise ValueError("this ViT has no register tokens to put out")
        # the ViT returns norm(x)[:, 1 + r:]; shifted by r, that is norm(x)[:, 1:-r]
        vit.norm.forward = lambda x: (lambda y: torch.cat([y[:, :r], y[:, :-r]], dim=1))(norm(x))
        try:
            yield
        finally:
            del vit.norm.forward
    else:
        raise ValueError(f"unknown fault {name!r}: one of {FAULTS}")


def faulted_outputs(driver, ref, name: str) -> dict:
    """{call: (warp, certainty, H[, pass-1 ViT tokens])} of the sampled
    calls, answered by `ref` with fault `name` in its ViT (the driver's
    `control_outputs` without the lowering of the rest); the tokens where
    the driver checks them."""
    from portbench.reference import keys as K

    res, num, out = driver.mix["res"], int(driver.mix["num_matches"]), {}
    for i in sorted(driver.sample):
        rows = driver._rows(i)
        with fault(ref.vit, name):
            w, c = ref.match(driver.a[rows], driver.b[rows])
            tokens = (driver._reference_tokens(ref, i),) if hasattr(driver, "_reference_tokens") else ()
        H = ref.sample_solve(w, c, num, (res, res), (res, res), K.split(driver.key(i), driver.batch))
        out[i] = (w, c, H.cpu(), *tokens)
    return out


def readings(cell, seeds: list[int], faults: list[str], device, emit) -> dict:
    from portbench import spec

    driver = spec.driver(cell.mix["kind"], cell.root).Driver(cell, seeds[0], device)
    driver.setup()
    ref = driver.reference()
    low: dict[str, dict[str, float]] = {f: {} for f in faults}
    for seed in seeds:
        driver.start(seed)
        for name in faults:
            checks = driver.check(faulted_outputs(driver, ref, name), ref)
            emit({"side": f"vit_{name}", "seed": seed, "checks": checks, "pairs": driver.pair_readings})
            for k, c in checks.items():
                low[name][k] = min(low[name].get(k, float("inf")), c["value"])
    limits = cell.config["limits"]
    return {name: {k: {"min": low[name].get(k), "limit": limits[k]} for k in limits} for name in faults}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--faults", default=",".join(FAULTS), help=f"comma-separated, of {FAULTS}")
    ap.add_argument("--out", help="also append every line to this file")
    args = ap.parse_args(argv)

    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    t0 = time.perf_counter()

    def emit(line: dict) -> None:
        line = {"workload": args.workload, "t": time.perf_counter() - t0, **line}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()

    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    emit({"summary": readings(spec.load_cell(args.workload), seeds, faults, "cuda", emit)})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
