"""Rounding of the reference's products, for the control of `correct`.

The reference computes in float32 with TF32 off. Its control is the same
reference computed one step of precision below what the configuration
states: the model's products (the configuration's bf16) on fp8 e4m3
operands scaled per tensor, and the sampling and solve's products (float32
with TF32 off) on TF32 operands. Inside `lowered()`, `model(t)` and
`solve(t)` round an operand so; outside, they return it as it is.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

Tensor = torch.Tensor

FP8_E4M3_MAX = 448.0
_LOWERED: contextvars.ContextVar[bool] = contextvars.ContextVar("portbench_lowered", default=False)


@contextlib.contextmanager
def lowered(on: bool = True):
    """Within the block, the reference's products take lowered operands."""
    token = _LOWERED.set(on)
    try:
        yield
    finally:
        _LOWERED.reset(token)


@contextlib.contextmanager
def exact():
    """Within the block, float32 products and convolutions on the device
    run in float32, not TF32; the flags are put back after it."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def fp8(t: Tensor) -> Tensor:
    """t rounded to fp8 e4m3 under one scale for the whole tensor (its
    largest magnitude at e4m3's largest finite value), back in float32."""
    t = t.float()
    amax = t.abs().amax()
    scale = torch.where(amax > 0, amax / FP8_E4M3_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def tf32(t: Tensor) -> Tensor:
    """float32 t rounded to TF32's 10 mantissa bits, to nearest even, as the
    tensor cores take a TF32 operand."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def model(t: Tensor) -> Tensor:
    """An operand of one of the model's products."""
    return fp8(t) if _LOWERED.get() else t


def solve(t: Tensor) -> Tensor:
    """An operand of one of the sampling's or the solve's products."""
    return tf32(t) if _LOWERED.get() else t
