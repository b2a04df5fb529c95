"""Shared neural-net primitives for the Wan stack (PyTorch port of
``more4d_tpu/nn/layers.py``). Norms run in float32 and cast back."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class RMSNorm(nn.Module):
    """RMS norm with learned scale (WanRMSNorm)."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True)
                                  + self.eps)
        return (normed * self.weight.float()).to(self.dtype)


def layer_norm(x, eps: float = 1e-6, weight=None, bias=None):
    """Layer norm in fp32, cast back to x's dtype (WanLayerNorm)."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


class LayerNormAffine(nn.Module):
    """Layer norm with learned scale/shift (norm3 when cross_attn_norm)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.eps, self.weight, self.bias)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` whatever the parameters are
    stored in — flax ``Dense(dtype=...)`` semantics (inputs, kernel and
    bias all cast to the compute dtype)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``dtype`` (flax ``Conv(dtype=...)``);
    channel-first like torch."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.dtype = dtype

    def forward(self, x):
        return self._conv_forward(x.to(self.dtype),
                                  self.weight.to(self.dtype),
                                  self.bias.to(self.dtype))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` that computes in ``dtype``; channel-first."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.dtype = dtype

    def forward(self, x):
        return self._conv_forward(x.to(self.dtype),
                                  self.weight.to(self.dtype),
                                  self.bias.to(self.dtype))


class LayerNormF32(nn.LayerNorm):
    """Affine layer norm computed in float32 (flax ``nn.LayerNorm(dtype=
    float32)``; flax's default eps is 1e-6, torch's 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return layer_norm(x.float(), self.eps, self.weight, self.bias)


def sinusoidal_embedding(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[cos | sin] sinusoidal timestep embedding (cos block first)."""
    if dim % 2:
        raise ValueError(f"sinusoidal_embedding needs an even dim, got {dim}")
    half = dim // 2
    position = position.float()
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                             device=position.device) / half)
    sinusoid = torch.outer(position.reshape(-1), freqs)
    emb = torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)
    return emb.reshape(*position.shape, dim)
