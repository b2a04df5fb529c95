"""Shared neural-net primitives for the Wan stack (PyTorch port of
``more4d_tpu/nn/layers.py``). Norms run in float32 and cast back."""

from __future__ import annotations

from typing import Optional

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


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``dtype`` (flax ``Conv(dtype=...)``);
    channel-first like torch."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.dtype = dtype

    def forward(self, x):
        return self._conv_forward(x.to(self.dtype),
                                  self.weight.to(self.dtype),
                                  _cast(self.bias, self.dtype))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` that computes in ``dtype``; channel-first."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.dtype = dtype

    def forward(self, x):
        return self._conv_forward(x.to(self.dtype),
                                  self.weight.to(self.dtype),
                                  _cast(self.bias, self.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in ``dtype``; channel-first.
    Its weight is torch's [in, out, kh, kw]; flax's ``ConvTranspose`` holds
    the same kernel spatially flipped as [kh, kw, in, out]."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.dtype = dtype

    def forward(self, x):
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  _cast(self.bias, self.dtype), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class LayerNormF32(nn.LayerNorm):
    """Affine layer norm computed in float32 (flax ``nn.LayerNorm(dtype=
    float32)``; flax's default eps is 1e-6, torch's 1e-5). The result is
    float32, or x's dtype with ``cast_back`` (the towers' norms, which
    normalise in float32 and cast back)."""

    def __init__(self, dim: int, eps: float = 1e-6, cast_back: bool = False):
        super().__init__(dim, eps=eps)
        self.cast_back = cast_back

    def forward(self, x):
        y = layer_norm(x.float(), self.eps, self.weight, self.bias)
        return y.to(x.dtype) if self.cast_back else y


def dense_attention(q, k, v, scale: Optional[float] = None, bias=None,
                    mask=None):
    """Plain softmax attention as the JAX towers write it (einsums, not the
    flash kernel): float32 scores q k^T (times ``scale`` when given) plus
    ``bias`` [.., H, Lq, Lk], keys where ``mask`` [B, Lk] is 0 set to
    float32's minimum (an all-masked row gives the uniform softmax, not
    NaN), softmax in float32, cast to v's dtype, then the product with v.
    q: [B, Lq, H, D]; k, v: [B, Lk, H, D]. Returns [B, Lq, H, D]."""
    s = torch.einsum("blnd,bmnd->bnlm", q.float(), k.float())
    if scale is not None:
        s = s * scale
    if bias is not None:
        s = s + bias.float()
    if mask is not None:
        s = s.masked_fill(mask[:, None, None, :] == 0,
                          torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bnlm,bmnd->blnd", p, v)


@torch.no_grad()
def lecun_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisation, untruncated: every Linear and conv
    weight N(0, 1/fan_in) (fan_in = input channels x kernel taps), biases
    zero, layer-norm scales one. Callers then set the parameters that
    initialise otherwise (tokens, tables, layer scales)."""
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
        elif isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            fan_in = m.weight[0].numel()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            continue
        else:
            continue
        m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        if m.bias is not None:
            m.bias.zero_()


def materialize(make, device, dtype: torch.dtype,
                generator: torch.Generator):
    """``make()``'s module with its parameters allocated on ``device`` in
    ``dtype`` and filled by its ``init_weights(generator)``, with no
    float32 copy on the way (the module is built on the meta device)."""
    with torch.device("meta"):
        module = make()
    module = module.to(dtype).to_empty(device=device)
    return module.init_weights(generator)


def from_state_dict(make, sd, dtype: torch.dtype):
    """``make()``'s module built on the meta device with ``sd`` assigned
    strictly (``load_state_dict(strict=True, assign=True)``), each floating
    tensor cast to ``dtype`` first: the weights are held once, never as a
    second (float32) copy. Returned in eval mode, on ``sd``'s device."""
    with torch.device("meta"):
        module = make()
    module.load_state_dict({k: v.to(dtype) if v.is_floating_point() else v
                            for k, v in sd.items()}, strict=True,
                           assign=True)
    return module.eval()


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
