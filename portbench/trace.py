"""The traced run's record: device operations, their launches, and the
benchmark's own spans around the program's layers.

`profile(call, first, count, layers)` runs `count` calls under
`torch.profiler` with a `record_function` span (`portbench.<layer>`) opened
by a forward pre-hook and closed by a forward hook on each module of
`layers`, and one span (`portbench.call`) around each call. The profiler's
Chrome trace is read back into plain lists, with times in microseconds on
the profiler's clock:

  ops     every device operation: name, kind (kernel, memcpy, memset),
          start, end, and the host time of its launch (None where the trace
          links none to it);
  spans   the benchmark's spans: name, start, end (host);
  calls   the spans of the calls, with the pairs each carried;
  window  from the first call's start to the last call's end.

A kernel belongs to a span if its launch lies inside it. A kernel that the
trace links to no launch takes the launch of the kernel before it on the
device, which ran before it on the same stream.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

import torch
from torch.autograd.profiler import record_function

from portbench import stats

SPAN = "portbench."
DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Forward hooks that open a span when a module starts and close it when
    it returns, on `layers` ({name: module}), until `remove()`."""

    def __init__(self, layers: dict):
        self.handles = []
        for name, module in layers.items():
            stack: list = []

            def pre(_m, _a, name=name, stack=stack):
                rf = record_function(SPAN + name)
                rf.__enter__()
                stack.append(rf)

            def post(_m, _a, _o, stack=stack):
                stack.pop().__exit__(None, None, None)

            self.handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def _read(path: str, pairs: list[int]) -> dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches = {}
    ops, spans, cpu = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args", {})
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = start
        elif cat in DEVICE_KINDS:
            ops.append({"name": e["name"], "kind": DEVICE_KINDS[cat], "start": start, "end": end,
                        "correlation": args.get("correlation")})
        elif cat == "user_annotation" and e["name"].startswith(SPAN):
            spans.append({"name": e["name"][len(SPAN):], "start": start, "end": end})
        elif cat == "cpu_op":
            cpu.append((start, end, e["name"]))
    ops.sort(key=lambda o: o["start"])
    last = None
    for o in ops:
        launch = launches.get(o.pop("correlation"))
        o["launch"] = launch if launch is not None else last
        last = o["launch"]
    calls = sorted((s for s in spans if s["name"] == "call"), key=lambda s: s["start"])
    for c, n in zip(calls, pairs):
        c["pairs"] = n
    window = (calls[0]["start"], calls[-1]["end"]) if calls else (0.0, 0.0)
    return {"ops": ops, "spans": [s for s in spans if s["name"] != "call"], "calls": calls,
            "window": window, "breakdown": _breakdown(ops, spans, cpu, window)}


def _breakdown(ops: list, spans: list, cpu: list, window) -> dict:
    """The ten device operations that took most time, and the ten longest
    stretches with no device operation, each named by the benchmark span and
    the host operation that were open when it began."""
    by_name: dict = defaultdict(float)
    for o in ops:
        by_name[o["name"]] += (o["end"] - o["start"]) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(stats.gaps([(o["start"], o["end"]) for o in ops], *window), key=lambda g: g[0] - g[1])[:10]

    def innermost(items, t):
        inside = [i for i in items if i[0] <= t < i[1]]
        return min(inside, key=lambda i: i[1] - i[0])[2] if inside else "-"

    span_items = [(s["start"], s["end"], s["name"]) for s in spans]
    named = [[f"{innermost(span_items, s)}/{innermost(cpu, s)}", (e - s) * 1e-6] for s, e in idle]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": named}


def profile(call, first: int, count: int, layers: dict) -> dict:
    """Run `call(i)` for i in [first, first + count) under the profiler;
    `call` returns the pairs it completed."""
    hooks = Spans(layers)
    pairs = []
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in range(first, first + count):
                with record_function(SPAN + "call"):
                    pairs.append(call(i))
        prof.export_chrome_trace(path)
        return _read(path, pairs)
    finally:
        hooks.remove()
        os.unlink(path)


def in_spans(ops: list, spans: list) -> list:
    """The operations launched inside any of `spans`."""
    bounds = [(s["start"], s["end"]) for s in spans]
    return [o for o in ops if o["launch"] is not None and any(a <= o["launch"] <= b for a, b in bounds)]


def kernel_name(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template arguments and parameters: `void (anonymous
    namespace)::local_corr_kernel<float, 8>(...)` is `local_corr_kernel`."""
    head = name.split("(", 1)[0] if not name.startswith("void (") else name[len("void "):]
    head = re.sub(r"\(anonymous namespace\)::", "", head).split("(", 1)[0].split("<", 1)[0]
    return head.split("::")[-1].strip().split(" ")[-1]


def device_seconds(ops: list) -> float:
    return sum(o["end"] - o["start"] for o in ops) * 1e-6


def busy_seconds(record: dict) -> float:
    """The time within the window in which some operation ran on the device."""
    return stats.busy([(o["start"], o["end"]) for o in record["ops"]], *record["window"]) * 1e-6


def per_call(record: dict, seconds: float) -> float:
    """`seconds` over the traced calls, in milliseconds a call."""
    return seconds * 1e3 / len(record["calls"])

