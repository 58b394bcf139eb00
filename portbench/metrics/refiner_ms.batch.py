"""refiner_ms: device milliseconds a call of the operations launched inside
the refiners' forwards (`m.head.conv_refiner[*]`), local correlation
included."""

from portbench.trace import device_seconds, in_spans, per_call


def read(record, cell):
    t = record["trace"]
    spans = [s for s in t["spans"] if s["name"].startswith("refiner.")]
    ops = in_spans(t["ops"], spans)
    return per_call(t, device_seconds(ops)) if ops else None
