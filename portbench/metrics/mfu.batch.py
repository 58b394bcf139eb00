"""mfu: the model's products for the pairs completed in the traced run's
unprofiled window (`work.model_flops`) over the window's time and the bf16
peak, in percent."""

from portbench import work


def read(record, cell):
    calls = record["calls"]
    if not calls:
        return None
    pairs = sum(c[2] for c in calls)
    seconds = calls[-1][1] - record["window_start"]
    flops = work.model_flops(cell.config, 1, int(cell.mix["num_matches"])) * pairs
    return 100.0 * flops / (seconds * work.PEAK_BF16_FLOPS)
