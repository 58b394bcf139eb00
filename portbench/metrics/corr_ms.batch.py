"""corr_ms: device milliseconds a call inside the program's `head.corr` span
(the global correlation of pass 1), between its CUDA events."""

from portbench import program_spans


def read(record, cell):
    return program_spans.device_ms(record, "head.corr")
