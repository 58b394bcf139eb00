"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights, the program, the pool of inputs, a warm-up of the cell's
shapes) is timed from the start of this script to the first timed call.
Then calls run back to back for `--seconds`; with `--trace 1` a few more
run under the profiler for the per-layer metrics. The device's peak memory
is read, the program is freed, and the plain reference checks a sample of
the window's answers. The last line of standard output is one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared beside its limit); the
same numbers end standard error. Without a CUDA device, or with fewer than
the cell asks for, or with JAX loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "gfnet_tpu"}


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def window(driver, seconds: float) -> tuple[list, float]:
    """Calls back to back until `seconds` have passed since the first began:
    [(start, end, pairs completed)] and the window's start."""
    calls, i = [], 0
    t0 = time.perf_counter()
    while True:
        start = time.perf_counter()
        if start - t0 >= seconds:
            return calls, t0
        done = driver.call(i)
        calls.append((start, time.perf_counter(), done))
        i += 1


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    import torch

    from portbench import spec, trace

    driver = spec.driver(cell.mix["kind"], cell.root).Driver(cell, seed, device)
    driver.setup()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    record = {"setup_s": time.perf_counter() - t_start, "pairs_per_call": driver.pairs_per_call()}
    record["calls"], record["window_start"] = window(driver, seconds)
    if traced:
        record["trace"] = trace.profile(driver.call, len(record["calls"]), int(cell.mix["profiled_calls"]),
                                        driver.layers())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    outputs = driver.program_outputs()
    driver.release()
    checks = driver.check(outputs, driver.reference())
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.metric(m["name"], cell.root).read(record, cell)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(record["calls"]) * record["pairs_per_call"]
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 1, "memory_peak_bytes": peak}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": attempted, "failed": attempted - sum(c[2] for c in record["calls"]),
              "metrics": metrics, "device": dev}
    if traced:
        t = record["trace"]
        dev["busy_s"] = trace.busy_seconds(t)
        dev["window_s"] = (t["window"][1] - t["window"][0]) * 1e-6
        result["breakdown"] = t["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    # caches of the libraries the program may build with, inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "portbench" / ".cache" / sub))
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
