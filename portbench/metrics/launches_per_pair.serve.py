"""launches_per_pair: kernels the traced calls ran, per pair."""


def read(record, cell):
    t = record["trace"]
    pairs = sum(c["pairs"] for c in t["calls"])
    kernels = sum(o["kind"] == "kernel" for o in t["ops"])
    return kernels / pairs if kernels and pairs else None
