"""Parameter layers that compute in a chosen type, as the JAX package's layers do.

Parameters are kept in float32 (the converted JAX weights); each call rounds
them and its input to ``compute_dtype``, as a JAX-package layer built with a
``dtype`` promotes its kernel and input before the product.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """The JAX package's ``Dense``: y = x·Wᵀ + b in ``compute_dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """The JAX package's ``Conv`` with symmetric k//2 padding, NCHW, in ``compute_dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel, stride, padding=kernel // 2,
                         groups=groups, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding, 1, self.groups)


class Embed(nn.Embedding):
    """The JAX package's ``Embed``: table rounded to ``compute_dtype``, then gathered."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_embeddings, features)
        self.compute_dtype = dtype

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx.long(), self.weight.to(self.compute_dtype))


class LayerNorm(nn.LayerNorm):
    """The JAX package's ``LayerNorm``: eps 1e-6, statistics in f32, output in ``compute_dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh approximation, the JAX package's ``gelu``."""
    return F.gelu(x, approximate="tanh")


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights at the JAX package's default scales (untruncated normals).

    Dense and conv kernels get lecun-normal weights (std 1/√fan_in) and zero
    biases; embedding tables std 1/√features; norms ones and zeros; other
    parameters (the virtual-node table) a unit normal. Draws are made on the
    CPU from ``generator`` in module order, so the same seed gives the same
    weights on every device.
    """

    def normal(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    done = set()
    for m in module.modules():
        if isinstance(m, (Dense, Conv2d)):
            fan_in = m.weight[0].numel()
            normal(m.weight, 1.0 / math.sqrt(fan_in))
        elif isinstance(m, Embed):
            normal(m.weight, 1.0 / math.sqrt(m.embedding_dim))
        elif isinstance(m, (nn.LayerNorm, BatchNorm2D)):
            m.weight.fill_(1.0)
        else:
            continue
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()
        done.update(id(p) for p in m.parameters(recurse=False))
    for p in module.parameters():
        if id(p) not in done:
            normal(p, 1.0)


class BatchNorm2D(nn.Module):
    """Stateless BN of the JAX package (NCHW): batch statistics ("batch": biased
    variance over N, H, W of this call, in training and in sampling alike) or
    a folded affine ("affine": y = x·scale + bias). Computes in f32 and returns
    the input's type."""

    def __init__(self, channels: int, mode: str = "batch", eps: float = 1e-5):
        super().__init__()
        if mode not in ("batch", "affine"):
            raise ValueError(f"unknown BatchNorm2D mode {mode!r}")
        self.mode = mode
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.mode == "batch":
            mean = xf.mean(dim=(0, 2, 3), keepdim=True)
            var = xf.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
            xf = (xf - mean) * torch.rsqrt(var + self.eps)
        return (xf * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)
