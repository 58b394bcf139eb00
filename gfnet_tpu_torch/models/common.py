"""Shared model building blocks.

Counterpart of `gfnet_tpu/models/common.py` (`LayerScale`, `swish`), plus the
dtype-aware layers that reproduce the JAX package's mixed precision: flax
layers keep float32 parameters and compute in a `dtype` (bf16 on the
flagship path), casting inputs and parameters per call. Feature maps are
NHWC as in the JAX package; a convolution views its NHWC input as a
channels-last NCHW tensor (`permute`, no copy) and returns NHWC.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


def swish(x: Tensor) -> Tensor:
    """x * sigmoid(x) (ref `model/FPN.py:88-93`)."""
    return x * torch.sigmoid(x)


class LayerScale(nn.Module):
    """Per-channel learned residual scaling (ref `layers/layer_scale.py:16-28`)."""

    def __init__(self, dim: int, init_values: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: Tensor) -> Tensor:
        return x * self.gamma.to(x.dtype)


class Dense(nn.Linear):
    """nn.Linear computing in `dtype` (flax `nn.Dense(dtype=...)`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics, output cast to `dtype` (flax
    `nn.LayerNorm(dtype=...)`)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.bfloat16):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


def conv_nhwc(x: Tensor, weight: Tensor, bias: Tensor | None, stride: int = 1,
              padding: int = 0, groups: int = 1) -> Tensor:
    """2-D convolution of an NHWC tensor with an OIHW weight → NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """Conv on NHWC computing in `dtype`, symmetric k//2 padding (the JAX
    `TorchConv` / `PwConv`). `depthwise=True` is the refiner's depthwise
    conv: taps accumulate in float32 and the result is cast once."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 bias: bool = True, depthwise: bool = False, padding: int | None = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.groups = in_ch if depthwise else 1
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // self.groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride = stride
        self.padding = kernel // 2 if padding is None else padding
        self.depthwise = depthwise
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype
        if self.depthwise:
            # bf16 inputs, float32 weights and accumulation (DepthwiseConv)
            x = x.to(dt).float()
            w, b = self.weight.float(), None if self.bias is None else self.bias.float()
        else:
            x, w = x.to(dt), self.weight.to(dt)
            b = None if self.bias is None else self.bias.to(dt)
        y = conv_nhwc(x, w, b, self.stride, self.padding, self.groups)
        return y.to(dt)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) dim in float32:
    (x - mean) * (weight * rsqrt(var + eps)) + bias (the JAX `PhaseBN` at
    phases=1). Returns float32.

    In eval mode it normalizes with the running statistics. In train mode it
    normalizes with the batch's moments, var = max(0, E[x²] - mean²), and
    moves the running statistics towards them by `momentum` (PyTorch's
    convention: flax's 0.99 is 0.01 here). The running variance takes the
    biased batch variance, as flax does and `F.batch_norm` does not. While
    `update_running` is False the running statistics stay put:
    `checkpoint_module` sets it for the forward that backward repeats.

    With a `mesh` (`parallel.mesh.Mesh`, set by `sync_batch_norms`) the
    moments are those of the global batch, as the JAX package's are over a
    sharded batch (`gfnet_tpu/models/refiner.py:200-205`): every rank holds
    as many rows (`parallel.shard_batch` splits evenly), so the global E[x]
    and E[x²] are the means of the ranks' own, all-reduced differentiably.
    In a world of one that is this process's arithmetic bit for bit."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.01):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps
        self.momentum = momentum
        self.update_running = True
        self.mesh = None

    def forward(self, x: Tensor) -> Tensor:
        xf = x.float()
        if self.training:
            red = tuple(range(x.dim() - 1))
            mean, mean_sq = xf.mean(red), (xf * xf).mean(red)
            if self.mesh is not None:  # every rank holds as many rows
                mean, mean_sq = self.mesh.all_reduce(torch.stack([mean, mean_sq])) / self.mesh.size
            var = (mean_sq - mean * mean).clamp_min(0.0)
            if self.update_running:
                with torch.no_grad():
                    self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
                    self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = self.weight.float() * torch.rsqrt(var + self.eps)
        return (xf - mean) * mul + self.bias.float()


@contextlib.contextmanager
def sync_batch_norms(module: nn.Module, mesh):
    """Within the block, every BatchNorm of `module` takes its training
    moments over the global batch of `mesh` (None: this process's batch)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in norms:
            m.mesh = None


def checkpoint_module(module: nn.Module, fn, *args):
    """`fn(*args)`, a function of `module`'s layers, with its activations
    recomputed in backward (`torch.utils.checkpoint`) instead of kept. The
    repeated forward normalizes with the same batch moments but leaves the
    BatchNorm running statistics alone, so a step updates them once. Calls
    nest: an inner call never switches on what an outer repeat switched off."""
    from torch.utils.checkpoint import checkpoint

    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    runs = 0

    def run(*a):
        nonlocal runs
        runs += 1
        before = [m.update_running for m in norms]
        for m, was in zip(norms, before):
            m.update_running = was and runs == 1
        try:
            return fn(*a)
        finally:
            for m, was in zip(norms, before):
                m.update_running = was

    return checkpoint(run, *args, use_reentrant=False)


class Act(nn.Module):
    """Cast to `dtype`, then the activation ("relu", "leaky_relu" at 0.1,
    "swish" or "none")."""

    def __init__(self, kind: str, dtype: torch.dtype):
        super().__init__()
        if kind not in ("relu", "leaky_relu", "swish", "none"):
            raise ValueError(f"unknown activation {kind!r}")
        self.kind, self.compute_dtype = kind, dtype

    def forward(self, x: Tensor) -> Tensor:
        x = x.to(self.compute_dtype)
        if self.kind == "relu":
            return F.relu(x)
        if self.kind == "leaky_relu":
            return F.leaky_relu(x, 0.1)
        if self.kind == "swish":
            return swish(x)
        return x


def gelu(x: Tensor) -> Tensor:
    """Exact (erf) GELU, except in bf16, where the JAX package uses the tanh
    approximation (`gfnet_tpu/models/vit.py:56-66`)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
