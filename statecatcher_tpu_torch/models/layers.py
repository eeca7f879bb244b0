"""Dense, Embed, LayerNorm and RMSNorm with flax semantics.

The JAX package's modules compute in ``dtype`` and keep parameters in
``param_dtype``; these do the same, with weights stored the PyTorch way
((out, in) for a dense kernel; ``convert.py`` transposes flax's (in, out)).
Parameters are created and initialised on the CPU from an explicit
``torch.Generator``, so one seed gives the same weights on every device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("float32", "bfloat16", "float64") → torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``xavier_uniform`` on an (out, in) weight."""
    fan_out, fan_in = w.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal`` (the ``nn.Dense`` default) on an (out, in)
    weight: truncated normal at ±2σ, variance 1/fan_in after truncation."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def orthogonal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``orthogonal`` on an (out, in) weight: orthonormal rows or
    columns, whichever are fewer."""
    with torch.no_grad():
        nn.init.orthogonal_(w, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x·Wᵀ + b computed in ``dtype`` (no b with
    ``use_bias=False``)."""

    def __init__(self, in_features: int, out_features: int, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, generator: torch.Generator,
                 kernel_init=lecun_normal_, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=param_dtype)) if use_bias
                     else None)
        if kernel_init is None:
            nn.init.zeros_(self.weight)
        else:
            kernel_init(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embed(nn.Module):
    """flax ``nn.Embed``: a (num, features) table, looked up in ``dtype``;
    initialised as flax's default (truncated normal, variance 1/features)."""

    def __init__(self, num_embeddings: int, features: int, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features, dtype=param_dtype))
        lecun_normal_(self.weight, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight.to(self.dtype)[ids.to(torch.int64)]


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics in at least float32, output in
    ``dtype``.  (flax takes the variance as E[x²]−E[x]², PyTorch in two
    passes; the difference is round-off, below the f32 tolerances.)"""

    def __init__(self, features: int, *, eps: float, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = torch.promote_types(self.dtype, torch.float32)
        y = F.layer_norm(x.to(cdt), (x.shape[-1],), self.weight.to(cdt),
                         self.bias.to(cdt), self.eps)
        return y.to(self.dtype)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm`` over the last axis: y = x · (rsqrt(mean(x²) + ε) ·
    scale), the mean square in at least float32, the output in ``dtype``."""

    def __init__(self, features: int, *, dtype: torch.dtype, param_dtype: torch.dtype,
                 eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(cdt)
        mul = torch.rsqrt(xs.square().mean(-1, keepdim=True) + self.eps) * self.weight.to(cdt)
        return (xs * mul).to(self.dtype)
