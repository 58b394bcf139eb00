"""The ViT-only faults of `control_vit.py` on a tiny reference ViT."""

import pytest
import torch

from portbench.control_vit import FAULTS, fault
from portbench.reference.vit_registers import ViTConfig, VisionTransformer


def tiny_vit():
    torch.manual_seed(0)
    vit = VisionTransformer(ViTConfig(d_model=48, depth=2, num_heads=3, pos_embed_size=4))
    with torch.no_grad():
        for p in vit.parameters():
            p.normal_(0.0, 0.5)
    return vit.eval()


@pytest.mark.parametrize("name", FAULTS)
def test_a_fault_moves_the_tokens_and_leaves_with_its_block(name):
    vit, x = tiny_vit(), torch.rand(1, 56, 56, 3)
    with torch.no_grad():
        clean = vit(x)
        with fault(vit, name):
            faulted = vit(x)
        after = vit(x)
    assert faulted.shape == clean.shape
    assert not torch.allclose(faulted, clean, atol=1e-4)
    assert torch.equal(after, clean)


def test_an_unknown_fault_and_a_backbone_without_registers_are_refused():
    vit = tiny_vit()
    with pytest.raises(ValueError):
        with fault(vit, "bf16"):
            pass
    plain = VisionTransformer(ViTConfig(d_model=48, depth=1, num_heads=3, pos_embed_size=4, num_register_tokens=0))
    for name in ("no_registers", "registers_out"):
        with pytest.raises(ValueError):
            with fault(plain, name):
                pass
