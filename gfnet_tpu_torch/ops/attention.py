"""Attention primitives for the ViT backbone and the cross-view decoder.

Counterpart of `gfnet_tpu/ops/attention.py`. `fused_attention` launches the
hand-written CUDA kernel K1 (`ops/kernels.py`, `csrc/oneshot_attention.cu`)
for CUDA tensors, with its gradient recomputed through the plain version, and
runs the plain `scaled_dot_product_attention` for CPU tensors.
`streamed_attention_plain` repeats the bf16 kernels' schedule (kv tiles,
running max and sum, base-2 exponentials, and above head dim 256 the logits
summed box by box) for the tests, `kv_split_attention_plain` their split of
the kv range and its merge, `column_group_attention_plain` the float32
kernel's column groups above head dim 256, and `attention_tf32_plain` its
three TF32 passes. The one semantic that must
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
                             tile: int = 64, box: int | None = None) -> Tensor:
    """The schedule of K1's bf16 kernels, step by step, in PyTorch: kv in
    tiles of `tile` keys, raw float32 logits, a running max and sum, the
    exponentials as exp2 with scale·log2(e) folded into the argument, the
    accumulator rescaled by exp2 of the max's move, probabilities cast to v's
    dtype before the PV product, the division after it. `box`: the logits
    summed over q's and k's channels `box` at a time, in order, as the wide
    kernel sums them (one 64-channel box a group of products); else in one
    product. Same function as `scaled_dot_product_attention`; the tests and
    the GPU smoke run hold it against the reference to catch a wrong fold or
    rescale off the card."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    c = scale * math.log2(math.e)
    b, nq, h, d = q.shape
    qf = q.float()
    m = torch.full((b, h, nq), -math.inf, device=q.device)
    l = torch.zeros((b, h, nq), device=q.device)
    o = torch.zeros((b, h, nq, v.shape[-1]), device=q.device)
    width = box or d
    for t0 in range(0, k.shape[1], tile):
        kt = k[:, t0:t0 + tile].float()
        s = torch.einsum("bnhd,bmhd->bhnm", qf[..., :width], kt[..., :width])
        for c0 in range(width, d, width):
            s = s + torch.einsum("bnhd,bmhd->bhnm", qf[..., c0:c0 + width], kt[..., c0:c0 + width])
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - (m_new * c)[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhnm,bmhd->bhnd", p.to(v.dtype).float(), v[:, t0:t0 + tile].float())
        o = o * alpha[..., None] + pv
        m = m_new
    return (o / l[..., None]).permute(0, 2, 1, 3).to(v.dtype)


def kv_split_attention_plain(q: Tensor, k: Tensor, v: Tensor, scale: float, kv_split: int) -> Tensor:
    """K1 with its kv range split (`kernels.attention_splits`), in PyTorch:
    each range of `kv_split` keys gives its rows' unnormalised output o_s,
    max m_s (log2 domain: logits · scale·log2(e)) and sum l_s, and the merge
    kernel's combination Σ 2^(m_s − M)·o_s / Σ 2^(m_s − M)·l_s, M = max m_s.
    float32; the same function as `scaled_dot_product_attention`."""
    c = scale * math.log2(math.e)
    parts = []
    for k0 in range(0, k.shape[1], kv_split):
        s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k[:, k0:k0 + kv_split].float()) * c
        m = s.amax(-1)
        p = torch.exp2(s - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bhnm,bmhd->bhnd", p, v[:, k0:k0 + kv_split].float())))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp2(m - big) for m, _, _ in parts]
    num = sum(wi[..., None] * o for wi, (_, _, o) in zip(w, parts))
    den = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    return (num / den[..., None]).permute(0, 2, 1, 3)


def column_group_attention_plain(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """The float32 K1's column groups in PyTorch: the logits over all of q's
    and k's channels, the same for every group, then the output
    `kernels.ATTENTION_F32_GROUP` columns of v at a time, concatenated.
    float32; the same function as `scaled_dot_product_attention` at any
    widths of q/k and v."""
    group = kernels.ATTENTION_F32_GROUP
    probs = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale, dim=-1)
    return torch.cat([torch.einsum("bhnm,bmhd->bnhd", probs, v[..., c0:c0 + group].float())
                      for c0 in range(0, v.shape[-1], group)], dim=-1)


def tf32_round(x: Tensor) -> Tensor:
    """float32 to TF32 as `cvt.rna.tf32.f32` rounds it: 10 mantissa bits, to
    nearest, ties away from zero (the low 13 bits cleared), by bit operations."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(eq: str, x: Tensor, y: Tensor, passes: int) -> Tensor:
    """einsum `eq` of float32 x and y on TF32 operands: hi·hi + hi·lo + lo·hi
    (hi = tf32(x), lo = tf32(x − hi)) with `passes` = 3, hi·hi alone with 1."""
    xh, yh = tf32_round(x), tf32_round(y)
    out = torch.einsum(eq, xh, yh)
    if passes == 3:
        out = out + torch.einsum(eq, xh, tf32_round(y - yh)) + torch.einsum(eq, tf32_round(x - xh), yh)
    return out


def attention_tf32_plain(q: Tensor, k: Tensor, v: Tensor, scale: float, passes: int = 3) -> Tensor:
    """The float32 kernel's products in PyTorch: Q·Kᵀ and P·V each as
    `passes` TF32 products (3: float32 precision; 1: a single TF32 pass),
    the softmax in float32. A model of the kernel's numbers, not of its
    schedule."""
    s = _tf32_product("bnhd,bmhd->bhnm", q.float(), k.float(), passes) * scale
    return _tf32_product("bhnm,bmhd->bnhd", torch.softmax(s, dim=-1), v.float(), passes)


class _FusedAttentionCUDA(torch.autograd.Function):
    """K1 forward, at any head dim (`kernels.oneshot_attention` zero-pads
    those it is not instantiated at, and runs the wide kernels above 256); the
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
