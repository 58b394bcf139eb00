"""The readings that each limit of `correct` is set from, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 --seconds 5

For each of `--seeds`, the program's window at the cell's own load, for
`--seconds` (long enough to reach every call the check may sample), and the
check as a run makes it: the sound readings. For each of `--control-seeds`,
the same sample of calls answered by the plain reference in the program's
place, one step of precision lower than the configuration states (its
products on fp8 operands, its sampling and solve on TF32 operands), and
checked against the float32 reference: the control's readings. Set-up is
made once. Prints one JSON line a seed, then one with each number's largest
sound reading and smallest control reading beside the configuration's limit.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seeds: list[int], control_seeds: list[int], seconds: float, device, emit) -> dict:
    from portbench import spec
    from portbench.run import window

    driver = spec.driver(cell.mix["kind"], cell.root).Driver(cell, seeds[0], device)
    driver.setup()
    ref = driver.reference()
    sound, control = {}, {}
    for seed in seeds:
        driver.start(seed)
        calls, _ = window(driver, seconds)
        checks = driver.check(driver.program_outputs(), ref)
        emit({"side": "program", "seed": seed, "calls": len(calls), "checks": checks, "pairs": driver.pair_readings})
        for name, c in checks.items():
            sound[name] = max(sound.get(name, 0.0), c["value"])
    for seed in control_seeds:
        driver.start(seed)
        checks = driver.check(driver.control_outputs(ref), ref)
        emit({"side": "control", "seed": seed, "checks": checks, "pairs": driver.pair_readings})
        for name, c in checks.items():
            control[name] = min(control.get(name, float("inf")), c["value"])
    limits = cell.config["limits"]
    return {name: {"sound_max": sound.get(name), "control_min": control.get(name), "limit": limits[name]}
            for name in limits}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of sound runs")
    ap.add_argument("--control-seeds", default="", help="comma-separated seeds of the control")
    ap.add_argument("--seconds", type=float, default=5.0)
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
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    emit({"summary": readings(spec.load_cell(args.workload), seeds, control_seeds, args.seconds, "cuda", emit)})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
