"""Motion-sensitive VAE adaptor pair, trajectory <-> pseudo-RGB (PyTorch
port of ``more4d_tpu/models/adaptors.py``): small per-frame 2D CNNs around
the frozen Wan VAE so it can encode/decode 3-channel xyz scene flow.

- encoder adaptor: conv_in(3->ch) -> res block(s) -> GroupNorm/swish ->
  zero-init conv_out(ch->3), then ``sigmoid(h + x)``;
- decoder adaptor: conv_in(3->ch) -> res blocks -> GroupNorm/swish ->
  conv_out(ch->3) => xyz flow.

Public tensors are [B, T, H, W, C]; frames are independent. Parameter names
are the reference torch checkpoint's (``down.0.block.i`` for the encoder,
``up.0.block.i`` for the decoder), as the JAX package's
``convert_adaptor_state_dict`` reads them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


class ResnetBlock2D(nn.Module):
    """GroupNorm(32)/swish/conv x2 with an identity shortcut."""

    def __init__(self, channels: int):
        super().__init__()
        groups = min(32, channels)
        self.norm1 = nn.GroupNorm(groups, channels, eps=1e-6)
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, channels, eps=1e-6)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        return x + self.conv2(F.silu(self.norm2(h)))


class _Adaptor(nn.Module):
    def __init__(self, ch, in_channels, out_channels, n_blocks, stage):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        level = nn.Module()
        level.block = nn.ModuleList(ResnetBlock2D(ch)
                                    for _ in range(n_blocks))
        setattr(self, stage, nn.ModuleList([level]))
        self.norm_out = nn.GroupNorm(min(32, ch), ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, out_channels, 3, padding=1)
        self._stage = stage

    def _frames(self, x):
        b, t, hh, ww, c = x.shape
        xf = x.float().reshape(b * t, hh, ww, c).permute(0, 3, 1, 2)
        h = self.conv_in(xf)
        # with a gradient taken, each res block runs again in the backward
        # (the same numbers, a fraction of the activations kept)
        remat = torch.is_grad_enabled()
        for blk in getattr(self, self._stage)[0].block:
            h = (torch.utils.checkpoint.checkpoint(blk, h,
                                                   use_reentrant=False)
                 if remat else blk(h))
        h = self.conv_out(F.silu(self.norm_out(h)))
        return xf, h

    @staticmethod
    def _unframe(y, b, t):
        n, c, hh, ww = y.shape
        return y.permute(0, 2, 3, 1).reshape(b, t, hh, ww, c)


class VAEEncoderAdaptor(_Adaptor):
    """xyz [B,T,H,W,3] -> pseudo-RGB in [0, 1]."""

    def __init__(self, ch: int = 128, in_channels: int = 3,
                 num_res_blocks: int = 1):
        super().__init__(ch, in_channels, in_channels, num_res_blocks,
                         "down")
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def forward(self, x):
        xf, h = self._frames(x)
        return self._unframe((h + xf).sigmoid(), *x.shape[:2])


class VAEDecoderAdaptor(_Adaptor):
    """Decoded pseudo-RGB [B,T,H,W,3] -> xyz flow [B,T,H,W,3]. Like the
    reference, it has num_res_blocks + 1 res blocks."""

    def __init__(self, ch: int = 128, in_channels: int = 3,
                 out_channels: int = 3, num_res_blocks: int = 1):
        super().__init__(ch, in_channels, out_channels, num_res_blocks + 1,
                         "up")

    def forward(self, z):
        _, h = self._frames(z)
        return self._unframe(h, *z.shape[:2])


def load_adaptor(path: str, decoder: bool):
    """An adaptor's state dict, from a reference torch ``.bin``/``.pth``
    (the names above) or a checkpoint directory of the port's trainers
    (``train/checkpoint.py``; params ``{'enc', 'dec'}``, and optionally
    ``'vae_decoder'``, a fine-tuned VAE decoder under ``WanVAE``'s
    ``decoder.*`` and ``conv2.*`` names). Returns (state dict, the VAE
    patch or None), the JAX package's ``load_adaptor`` pair."""
    import os

    import torch

    if os.path.isdir(path):
        from ..train.checkpoint import CheckpointManager, refuse_orbax

        refuse_orbax(path)
        tree = CheckpointManager(path).restore_params()
        return tree["dec" if decoder else "enc"], tree.get("vae_decoder")
    return torch.load(path, map_location="cpu", weights_only=True), None
