"""vit_ffn_ms: device milliseconds a call inside the program's `vit.ffn`
spans (each ViT block's FFN: fc1, GELU, fc2 or w12, the gate, w3; both passes),
between their CUDA events. The norms, LayerScale and residual adds lie
outside them. None where the program opens no such span."""

from portbench import program_spans


def read(record, cell):
    return program_spans.device_ms(record, "vit.ffn")
