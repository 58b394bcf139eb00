"""The program's own spans and counters of the traced run.

The port records its spans and counters (`gfnet_tpu_torch.utils.profiling`)
while a profiler records, so once the traced calls have run its recorder
holds them: each closed span's name, parent, device ms and counters. A
span's device ms is the interval between two CUDA events on the stream,
so it holds whatever idle time the device had inside the span; it is read
only for layers that keep the device busy once they start. The host's ms
are not read: under the profiler they time the profiler. The recorder is
read from the program the cell's driver loaded; nothing here imports the
program. A reader divides by the program's own outermost `call` spans, and
reads nothing (None) where their number is not that of the traced calls,
or where the program has no recorder.
"""

from __future__ import annotations

import sys

RECORDER = "gfnet_tpu_torch.utils.profiling"  # the program's module that keeps its spans


def spans(record) -> tuple[list, int] | None:
    """(the program's spans, its calls) of the traced run, or None."""
    records = getattr(sys.modules.get(RECORDER), "records", None)
    if records is None:
        return None
    found = records()
    calls = sum(s["name"] == "call" and s["parent"] is None for s in found)
    if not calls or calls != len(record["trace"]["calls"]):
        return None
    return found, calls


def device_ms(record, name: str) -> float | None:
    """Device ms a call in the spans named `name`."""
    got = spans(record)
    if got is None:
        return None
    found, calls = got
    ms = [s["device_ms"] for s in found if s["name"] == name]
    return sum(ms) / calls if ms and None not in ms else None


def per_pair(record, counter: str) -> float | None:
    """Counter `counter` over every span of the traced calls, a pair."""
    got = spans(record)
    if got is None:
        return None
    found, _ = got
    pairs = sum(c["pairs"] for c in record["trace"]["calls"])
    return sum(s["counters"].get(counter, 0) for s in found) / pairs if pairs else None
