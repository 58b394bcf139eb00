"""pairs_per_s: the pairs completed in the window over the window's time,
from its start to the end of its last call."""


def read(record, cell):
    calls = record["calls"]
    return sum(c[2] for c in calls) / (calls[-1][1] - record["window_start"]) if calls else None
