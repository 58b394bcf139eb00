"""Attention primitives for the ViT backbone and the cross-view decoder.

Counterpart of `gfnet_tpu/ops/attention.py`. `fused_attention` launches the
hand-written CUDA kernel K1 (`ops/kernels.py`, `csrc/oneshot_attention.cu`)
for CUDA tensors, with its gradient recomputed through the plain version, and
runs the plain `scaled_dot_product_attention` for CPU tensors.
`streamed_attention_plain` repeats the kernels' schedule (kv tiles, running
max and sum, base-2 exponentials) for the tests. The one semantic that must
survive is the "entropy invariance" softmax scale, head_dim^-0.5 · log(N) / log(train_avg_length)
(ref `attention.py:84,213,249`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gfnet_tpu_torch.ops import kernels

Tensor = torch.Tensor


def entropy_invariant_scale(head_dim: int, seq_len: int, train_avg_length: int | None) -> float:
    scale = head_dim**-0.5
    if train_avg_length is not None:
        scale *= math.log(seq_len) / math.log(train_avg_length)
    return scale


def scaled_dot_product_attention(q: Tensor, k: Tensor, v: Tensor, scale: float | None = None) -> Tensor:
    """Plain version of K1. q, k, v: (B, N, H, D) → (B, N, H, D); logits and
    softmax in float32, probabilities cast to v's dtype for the PV product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v)


def streamed_attention_plain(q: Tensor, k: Tensor, v: Tensor, scale: float | None = None,
                             tile: int = 64) -> Tensor:
    """The schedule of K1's bf16 kernels, step by step, in PyTorch: kv in
    tiles of `tile` keys, raw float32 logits, a running max and sum, the
    exponentials as exp2 with scale·log2(e) folded into the argument, the
    accumulator rescaled by exp2 of the max's move, probabilities cast to v's
    dtype before the PV product, the division after it. Same function as
    `scaled_dot_product_attention`; the tests and the GPU smoke run hold it
    against the reference to catch a wrong fold or rescale off the card."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    c = scale * math.log2(math.e)
    b, nq, h, d = q.shape
    qf = q.float()
    m = torch.full((b, h, nq), -math.inf, device=q.device)
    l = torch.zeros((b, h, nq), device=q.device)
    o = torch.zeros((b, h, nq, d), device=q.device)
    for t0 in range(0, k.shape[1], tile):
        s = torch.einsum("bnhd,bmhd->bhnm", qf, k[:, t0:t0 + tile].float())
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - (m_new * c)[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhnm,bmhd->bhnd", p.to(v.dtype).float(), v[:, t0:t0 + tile].float())
        o = o * alpha[..., None] + pv
        m = m_new
    return (o / l[..., None]).permute(0, 2, 1, 3).to(v.dtype)


class _FusedAttentionCUDA(torch.autograd.Function):
    """K1 forward, at any head dim up to 128 (`kernels.oneshot_attention`
    zero-pads those it is not instantiated at; above 128 it raises); the
    backward recomputes through the plain version at the caller's head dim,
    as the JAX package pairs its kernel with an einsum backward
    (`ops/attention.py:122-147`). It has no attention backward kernel."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return kernels.oneshot_attention(q, k, v, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad: Tensor):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = scaled_dot_product_attention(*qkv, ctx.scale)
        return (*torch.autograd.grad(out, qkv, grad), None)


def fused_attention(q: Tensor, k: Tensor, v: Tensor, scale: float | None = None) -> Tensor:
    """Non-causal attention over (B, N, H, D): kernel K1 on CUDA tensors,
    the plain version on CPU tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _FusedAttentionCUDA.apply(q, k, v, float(scale))
    return scaled_dot_product_attention(q, k, v, scale)


def linear_attention(q: Tensor, k: Tensor, v: Tensor, eps: float = 1e-6) -> Tensor:
    """elu(x)+1 linear attention in float32 (ref `attention.py:261-291`).
    q, k, v: (B, N, H, D) → (B, N, H, D)."""
    q = F.elu(q.float()) + 1
    k = F.elu(k.float()) + 1
    kv = torch.einsum("bshd,bshm->bhmd", k, v.float())
    z = 1.0 / (torch.einsum("blhd,bhd->blh", q, k.sum(1)) + eps)
    return torch.einsum("blhd,bhmd,blh->blhm", q, kv, z).to(v.dtype)
