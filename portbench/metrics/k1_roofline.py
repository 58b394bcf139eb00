"""k1_roofline: the least time of every attention a call needs (counted from
the configuration's shapes, `work.attention_calls`) over the device time of
the kernels named `oneshot_attention*` (K1 and its kv-split merge), in
percent."""

from portbench import work
from portbench.trace import device_seconds, kernel_name


def read(record, cell):
    t = record["trace"]
    spent = device_seconds([o for o in t["ops"] if kernel_name(o["name"]).startswith("oneshot_attention")])
    if spent <= 0:
        return None
    pairs = sum(c["pairs"] for c in t["calls"])
    least = sum(work.least_seconds(a.flops, a.bytes) for a in work.attention_calls(cell.config, 1))
    return 100.0 * least * pairs / spent
