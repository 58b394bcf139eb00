"""vit_attn_ms: device milliseconds a call inside the program's `vit.attn`
spans (each ViT block's attention: qkv, K1 and proj; both passes),
between their CUDA events. The norms, LayerScale and residual adds lie
outside them. None where the program opens no such span."""

from portbench import program_spans


def read(record, cell):
    return program_spans.device_ms(record, "vit.attn")
