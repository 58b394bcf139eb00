"""sample_solve_ms: device milliseconds a call of the operations launched
after the call's last head forward (pass 2's) returned and before the call
returned: the warp stitch, the draws, the sampling and the solve."""

from portbench.trace import device_seconds, in_spans, per_call


def read(record, cell):
    t = record["trace"]
    heads = [s for s in t["spans"] if s["name"] == "head"]
    after = []
    for c in t["calls"]:
        ends = [h["end"] for h in heads if c["start"] <= h["start"] <= c["end"]]
        if ends:
            after.append({"start": max(ends), "end": c["end"]})
    ops = in_spans(t["ops"], after)
    return per_call(t, device_seconds(ops)) if ops else None
