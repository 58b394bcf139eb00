"""latency_p95_ms: the 95th percentile of every call's wait in the window."""

from portbench.stats import percentile


def read(record, cell):
    return percentile([(e - s) * 1e3 for s, e, _ in record["calls"]], 95) if record["calls"] else None
