"""latency_p50_ms: the median wait of a call in the window, host clock."""

from portbench.stats import percentile


def read(record, cell):
    return percentile([(e - s) * 1e3 for s, e, _ in record["calls"]], 50) if record["calls"] else None
