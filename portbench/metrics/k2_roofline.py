"""k2_roofline: the least time of every local correlation a call needs
(counted from the configuration's shapes, `work.local_corr_calls`) over the
device time of the kernels named `local_corr_kernel` (K2), in percent."""

from portbench import work
from portbench.trace import device_seconds, kernel_name


def read(record, cell):
    t = record["trace"]
    spent = device_seconds([o for o in t["ops"] if kernel_name(o["name"]) == "local_corr_kernel"])
    if spent <= 0:
        return None
    pairs = sum(c["pairs"] for c in t["calls"])
    least = sum(work.least_seconds(c.flops, c.bytes) for c in work.local_corr_calls(cell.config, 1))
    return 100.0 * least * pairs / spent
