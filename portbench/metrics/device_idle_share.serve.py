"""device_idle_share: the share of the traced calls' time in which no
operation ran on the device, in percent."""

from portbench.trace import busy_seconds


def read(record, cell):
    t = record["trace"]
    span = (t["window"][1] - t["window"][0]) * 1e-6
    return 100.0 * (1.0 - busy_seconds(t) / span) if t["ops"] and span > 0 else None
