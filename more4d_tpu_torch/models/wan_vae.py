"""Wan 3D-causal video VAE (PyTorch port of ``more4d_tpu/models/wan_vae.py``).

Every module takes ``(x, cache)`` and returns ``(y, new_cache)`` like the
JAX package: ``cache=None`` is the full-sequence causal computation (a
stride-1 causal conv sees two leading zero frames; the temporal downsample
passes frame 0 through; the temporal upsample passes frame 0 through and
runs the rest with zero history), and threading the returned caches through
chunks gives the streamed computation of ``vae_streaming``.

Internally the tensors are channel-first ``[B, C, T, H, W]`` for torch's
convolutions; ``WanVAE.encode``/``decode`` take and return the JAX layout
``[B, T, H, W, C]``. Module and parameter names are the released
``Wan2.1_VAE.pth`` keys (the JAX package's ``convert/vae_torch.py``), so a
released state dict loads as is. Modules compute in the dtype of their
input; ``WanVAE`` casts its input to ``cfg.dtype``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VAEConfig, WAN_VAE_LATENT_MEAN, WAN_VAE_LATENT_STD

CACHE_T = 2

Cache = Optional[Dict[str, Any]]


def _get(cache: Cache, name: str):
    return None if cache is None else cache.get(name)


def _per_frame(fn, x):
    """Apply a 2D module to every frame of [B, C, T, H, W]."""
    b, c, t, h, w = x.shape
    y = fn(x.transpose(1, 2).reshape(b * t, c, h, w))
    return y.reshape(b, t, *y.shape[1:]).transpose(1, 2)


class RMSNorm(nn.Module):
    """Channel L2-normalise * sqrt(C) * gamma (``F.normalize`` semantics:
    eps 1e-12 on the norm, no mean-square eps). Channel dim 1."""

    def __init__(self, dim: int, images: bool = False):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones((dim, 1, 1) if images
                                             else (dim, 1, 1, 1)))

    def forward(self, x):
        y = F.normalize(x.float(), dim=1, eps=1e-12) * self.scale
        return (y * self.gamma.float()).to(x.dtype)


class CausalConv3d(nn.Conv3d):
    """Causal 3D conv: 2*(kt//2) leading history frames (zeros, or the
    cache = the last two frames of the input stream), SAME spatial
    padding."""

    def __init__(self, cin: int, cout: int, kernel=3):
        if isinstance(kernel, int):
            kernel = (kernel,) * 3
        super().__init__(cin, cout, kernel,
                         padding=(0, kernel[1] // 2, kernel[2] // 2))

    def forward(self, x, cache=None):
        pt = self.kernel_size[0] // 2
        new_cache = None
        if pt > 0:
            if cache is None:
                b, c, _, h, w = x.shape
                cache = x.new_zeros((b, c, 2 * pt, h, w))
            x = torch.cat([cache, x], dim=2)
            new_cache = x[:, :, -CACHE_T:]
        y = self._conv_forward(x, self.weight.to(x.dtype),
                               self.bias.to(x.dtype))
        return y, new_cache


class ResidualBlock(nn.Module):
    """norm-silu-conv x2 + shortcut. ``residual`` indices follow the
    reference Sequential (0 norm, 2 conv, 3 norm, 6 conv)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.residual = nn.ModuleList([
            RMSNorm(in_dim), nn.SiLU(), CausalConv3d(in_dim, out_dim, 3),
            RMSNorm(out_dim), nn.SiLU(), nn.Identity(),
            CausalConv3d(out_dim, out_dim, 3)])
        self.shortcut = (CausalConv3d(in_dim, out_dim, 1)
                         if in_dim != out_dim else None)

    def forward(self, x, cache: Cache = None):
        r = self.residual
        h, c1 = r[2](F.silu(r[0](x)), _get(cache, "conv1"))
        h, c2 = r[6](F.silu(r[3](h)), _get(cache, "conv2"))
        s = x if self.shortcut is None else self.shortcut(x)[0]
        return h + s, {"conv1": c1, "conv2": c2}


class AttentionBlock(nn.Module):
    """Per-frame single-head self-attention; softmax in fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = RMSNorm(dim, images=True)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1)
        self.proj = nn.Conv2d(dim, dim, 1)

    def _frame(self, x):
        n, c, h, w = x.shape
        y = self.norm(x)
        qkv = F.conv2d(y, self.to_qkv.weight.to(y.dtype),
                       self.to_qkv.bias.to(y.dtype))
        q, k, v = qkv.reshape(n, 3 * c, h * w).transpose(1, 2).chunk(3, -1)
        s = torch.bmm(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
        p = s.softmax(dim=-1).to(x.dtype)
        o = torch.bmm(p, v).transpose(1, 2).reshape(n, c, h, w)
        return F.conv2d(o, self.proj.weight.to(o.dtype),
                        self.proj.bias.to(o.dtype))

    def forward(self, x):
        return x + _per_frame(self._frame, x)


class Resample(nn.Module):
    """Spatial 2x down (zero-pad right/bottom + 3x3 stride-2 conv) or up
    (nearest 2x + 3x3 conv to dim//2), with the temporal conv of the '3d'
    modes: downsample3d is a stride-2 conv whose frame 0 passes through
    (cache = last input frame); upsample3d makes 2*dim channels that
    interleave into 2x frames, frame 0 passing through (cache = the last
    two stream frames, zeros right after frame 0)."""

    def __init__(self, dim: int, mode: str):
        super().__init__()
        self.mode = mode
        if mode.startswith("downsample"):
            self.resample = nn.Sequential(nn.ZeroPad2d((0, 1, 0, 1)),
                                          nn.Conv2d(dim, dim, 3, stride=2))
        else:
            # index 0 is the reference's nearest 2x upsample (done in
            # _spatial); the conv keeps its released key resample.1
            self.resample = nn.Sequential(nn.Identity(),
                                          nn.Conv2d(dim, dim // 2, 3,
                                                    padding=1))
        self.time_conv = None
        if mode == "downsample3d":
            self.time_conv = nn.Conv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1))
        elif mode == "upsample3d":
            self.time_conv = nn.Conv3d(dim, 2 * dim, (3, 1, 1))

    def _spatial(self, x):
        conv = self.resample[1]

        def frame(y):
            if self.mode.startswith("upsample"):
                y = y.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            y = self.resample[0](y)
            return F.conv2d(y, conv.weight.to(y.dtype), conv.bias.to(y.dtype),
                            stride=conv.stride, padding=conv.padding)

        return _per_frame(frame, x)

    def _tconv(self, x):
        tc = self.time_conv
        return F.conv3d(x, tc.weight.to(x.dtype), tc.bias.to(x.dtype),
                        stride=tc.stride)

    def forward(self, x, cache=None):
        new_cache = None
        if self.mode == "downsample3d":
            x = self._spatial(x)
            if cache is None:
                rest = self._tconv(x) if x.shape[2] >= 3 else x[:, :, :0]
                out = torch.cat([x[:, :, :1], rest], dim=2)
            else:
                out = self._tconv(torch.cat([cache, x], dim=2))
            return out, x[:, :, -1:]
        if self.mode == "upsample3d":
            b, c, t, h, w = x.shape
            if cache is None:
                stream = x[:, :, 1:]
                hist = x.new_zeros((b, c, 2, h, w))
                if stream.shape[2] > 0:
                    inp = torch.cat([hist, stream], dim=2)
                    out = torch.cat([x[:, :, :1],
                                     self._interleave(self._tconv(inp))], 2)
                    new_cache = inp[:, :, -CACHE_T:]
                else:
                    out, new_cache = x[:, :, :1], hist
            else:
                inp = torch.cat([cache, x], dim=2)
                out = self._interleave(self._tconv(inp))
                new_cache = inp[:, :, -CACHE_T:]
            x = out
        return self._spatial(x), new_cache

    @staticmethod
    def _interleave(y):
        """[B, 2C, T, H, W] -> [B, C, 2T, H, W]: channel group g becomes
        time offset g."""
        b, c2, t, h, w = y.shape
        y = y.reshape(b, 2, c2 // 2, t, h, w).permute(0, 2, 3, 1, 4, 5)
        return y.reshape(b, c2 // 2, 2 * t, h, w)


class Encoder3d(nn.Module):
    """dims dim*[1, *dim_mult]; each stage's res blocks then a downsample
    (temporal where cfg.temporal_downsample says so)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
        self.conv1 = CausalConv3d(3, dims[0], 3)
        layers = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(cfg.num_res_blocks):
                layers.append(ResidualBlock(in_dim, out_dim))
                in_dim = out_dim
            if i != len(cfg.dim_mult) - 1:
                mode = ("downsample3d" if cfg.temporal_downsample[i]
                        else "downsample2d")
                layers.append(Resample(out_dim, mode))
        self.downsamples = nn.ModuleList(layers)
        self.middle = nn.ModuleList([ResidualBlock(dims[-1], dims[-1]),
                                     AttentionBlock(dims[-1]),
                                     ResidualBlock(dims[-1], dims[-1])])
        self.head = nn.ModuleList([RMSNorm(dims[-1]), nn.SiLU(),
                                   CausalConv3d(dims[-1], cfg.z_dim * 2, 3)])

    def forward(self, x, cache: Cache = None):
        caches = {}
        x, caches["conv1"] = self.conv1(x, _get(cache, "conv1"))
        for i, layer in enumerate(self.downsamples):
            x, caches[f"down_{i}"] = layer(x, _get(cache, f"down_{i}"))
        x = _middle(self, x, cache, caches)
        return _head(self, x, cache, caches), caches


def _middle(coder, x, cache, caches):
    x, caches["mid_res1"] = coder.middle[0](x, _get(cache, "mid_res1"))
    x = coder.middle[1](x)
    x, caches["mid_res2"] = coder.middle[2](x, _get(cache, "mid_res2"))
    return x


def _head(coder, x, cache, caches):
    x = F.silu(coder.head[0](x))
    x, caches["head_conv"] = coder.head[2](x, _get(cache, "head_conv"))
    return x


class Decoder3d(nn.Module):
    """Mirror of the encoder: middle first, then each stage's res blocks
    and an upsample (temporal where the reversed pattern says so)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        mult = tuple(cfg.dim_mult)
        dims = [cfg.dim * u for u in (mult[-1],) + mult[::-1]]
        temporal_up = tuple(cfg.temporal_downsample)[::-1]
        self.conv1 = CausalConv3d(cfg.z_dim, dims[0], 3)
        self.middle = nn.ModuleList([ResidualBlock(dims[0], dims[0]),
                                     AttentionBlock(dims[0]),
                                     ResidualBlock(dims[0], dims[0])])
        layers = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            if i > 0:
                in_dim = in_dim // 2       # the previous upsample halved it
            for _ in range(cfg.num_res_blocks + 1):
                layers.append(ResidualBlock(in_dim, out_dim))
                in_dim = out_dim
            if i != len(mult) - 1:
                layers.append(Resample(out_dim, "upsample3d" if temporal_up[i]
                                       else "upsample2d"))
        self.upsamples = nn.ModuleList(layers)
        self.head = nn.ModuleList([RMSNorm(dims[-1]), nn.SiLU(),
                                   CausalConv3d(dims[-1], 3, 3)])

    def forward(self, x, cache: Cache = None):
        caches = {}
        x, caches["conv1"] = self.conv1(x, _get(cache, "conv1"))
        x = _middle(self, x, cache, caches)
        for i, layer in enumerate(self.upsamples):
            x, caches[f"up_{i}"] = layer(x, _get(cache, f"up_{i}"))
        return _head(self, x, cache, caches), caches


class WanVAE(nn.Module):
    """encode: [B,T,H,W,3] -> (mu, logvar) each [B,T',H/8,W/8,z]; decode
    back. mu is normalised per channel ((mu - mean)/std) when
    ``normalize=True``."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder3d(cfg)
        self.decoder = Decoder3d(cfg)
        self.conv1 = CausalConv3d(cfg.z_dim * 2, cfg.z_dim * 2, 1)
        self.conv2 = CausalConv3d(cfg.z_dim, cfg.z_dim, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "WanVAE":
        """Random weights from ``generator``: xavier-uniform convolutions,
        unit norms, zero biases."""
        for name, p in self.named_parameters():
            if name.endswith("weight"):
                nn.init.xavier_uniform_(p, generator=generator)
            elif name.endswith("bias"):
                p.zero_()
        return self

    def _latent_stats(self, device):
        if self.cfg.z_dim == len(WAN_VAE_LATENT_MEAN):
            mean, std = WAN_VAE_LATENT_MEAN, WAN_VAE_LATENT_STD
        else:                                   # tiny test configs
            mean, std = (0.0,) * self.cfg.z_dim, (1.0,) * self.cfg.z_dim
        return (torch.tensor(mean, dtype=torch.float32, device=device),
                torch.tensor(std, dtype=torch.float32, device=device))

    def encode(self, x, normalize: bool = True, cache: Cache = None,
               return_cache: bool = False):
        x = x.to(self.cfg.dtype).permute(0, 4, 1, 2, 3)
        h, caches = self.encoder(x, _get(cache, "encoder"))
        h, cc = self.conv1(h, _get(cache, "conv1"))
        mu, logvar = h.permute(0, 2, 3, 4, 1).chunk(2, dim=-1)
        if normalize:
            mean, std = self._latent_stats(mu.device)
            mu = (mu - mean) / std
        if return_cache:
            return (mu, logvar), {"encoder": caches, "conv1": cc}
        return mu, logvar

    def decode(self, z, normalize: bool = True, cache: Cache = None,
               return_cache: bool = False, clip: bool = True):
        if normalize:
            mean, std = self._latent_stats(z.device)
            z = z * std + mean
        z = z.to(self.cfg.dtype).permute(0, 4, 1, 2, 3)
        h, cc = self.conv2(z, _get(cache, "conv2"))
        x, caches = self.decoder(h, _get(cache, "decoder"))
        x = x.permute(0, 2, 3, 4, 1)
        if clip:
            x = x.clamp(-1.0, 1.0)
        if return_cache:
            return x, {"decoder": caches, "conv2": cc}
        return x
