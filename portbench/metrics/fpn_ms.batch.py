"""fpn_ms: device milliseconds a call inside the program's `head.fpn` spans
(the FPN encoder, merge and decoder; both passes), between their CUDA events."""

from portbench import program_spans


def read(record, cell):
    return program_spans.device_ms(record, "head.fpn")
