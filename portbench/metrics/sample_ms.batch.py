"""sample_ms: device milliseconds a call inside the program's `sample` span
(Gumbel top-k, KDE, the balanced draw), between its CUDA events."""

from portbench import program_spans


def read(record, cell):
    return program_spans.device_ms(record, "sample")
