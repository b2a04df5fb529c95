"""OmniMAE ViT-B feature extractor for the Motion Perception Module
(PyTorch port of ``more4d_tpu/models/omnimae.py``).

The one path MoRe4D uses, the trunk's ``forward_patch_features``: the
ImageNet-normalised first frame, bilinearly resized to 224^2 (the JAX
resize, antialiased), repeated to a 2-frame clip, patchified by a Conv3d
[2, 16, 16], plus a fixed sinusoid position table, 12 pre-norm ViT blocks
(layer norms eps 1e-6, exact GELU) and a final layer norm; all 196 patch
tokens come out, and token 0 as the pooled feature (no cls token).
Parameter names are the reference trunk's (``patch_embed.proj.1`` is the
Conv3d after the frame repeat, ``blocks.N.attn.qkv``, ``blocks.N.mlp.fc1``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..nn.layers import (Conv3d, LayerNormF32, Linear, dense_attention,
                         lecun_init_)
from ..nn.resize import resize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """The [n_position, d_hid] float32 sinusoid position table."""
    pos = np.arange(n_position)[:, None]
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (j // 2) / d_hid)
    table = np.where(j % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


def imagenet_normalize(images01: torch.Tensor) -> torch.Tensor:
    """[..., 3] in [0, 1] -> ImageNet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN, device=images01.device)
    std = torch.tensor(IMAGENET_STD, device=images01.device)
    return (images01 - mean) / std


class ViTAttention(nn.Module):
    """Fused-qkv softmax attention with the 1/sqrt(d) scale."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)

    def forward(self, x):
        b, l, c = x.shape
        n, d = self.num_heads, c // self.num_heads
        q, k, v = (t.reshape(b, l, n, d) for t in self.qkv(x).chunk(3, -1))
        return self.proj(dense_attention(q, k, v, d ** -0.5).reshape(b, l, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype)
        self.act = nn.GELU()
        self.fc2 = Linear(hidden, dim, dtype)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-norm ViT block (timm's names: norm1, attn, norm2, mlp)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNormF32(dim, eps, cast_back=True)
        self.attn = ViTAttention(dim, num_heads, dtype)
        self.norm2 = LayerNormF32(dim, eps, cast_back=True)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _RepeatFrames(nn.Module):
    """[B, C, H, W] -> [B, C, frames, H, W] (the reference's PadIm2Video
    'repeat', index 0 of ``patch_embed.proj``)."""

    def __init__(self, frames: int):
        super().__init__()
        self.frames = frames

    def forward(self, x):
        return x[:, :, None].expand(-1, -1, self.frames, -1, -1)


class OmniMAEViT(nn.Module):
    """forward_patch_features: [B, 224, 224, 3] (normalised) -> (patch
    tokens [B, 196, D], pooled [B, D])."""

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12,
                 patch_size: Tuple[int, int, int] = (2, 16, 16),
                 image_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.image_size, self.dtype = (embed_dim, image_size,
                                                       dtype)
        self.patch_size = tuple(patch_size)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Sequential(
            _RepeatFrames(patch_size[0]),
            Conv3d(3, embed_dim, patch_size, stride=patch_size, dtype=dtype))
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, num_heads,
                                             dtype=dtype)
                                    for _ in range(depth))
        self.norm = LayerNormF32(embed_dim, 1e-6, cast_back=True)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "OmniMAEViT":
        """flax's defaults (``lecun_init_``)."""
        lecun_init_(self, generator)
        return self

    def forward(self, x):
        _, ph, pw = self.patch_size
        h = self.patch_embed.proj(x.permute(0, 3, 1, 2))
        h = h.flatten(2).transpose(1, 2)                       # [B, N, D]
        n_pos = (self.image_size // ph) * (self.image_size // pw)
        pos = torch.from_numpy(sinusoid_table(n_pos, self.embed_dim))
        h = h + pos.to(h.device, h.dtype)[None]
        for blk in self.blocks:
            h = blk(h)
        h = self.norm(h)
        return h, h[:, 0]


def extract_mpm_features(model: OmniMAEViT, images01: torch.Tensor):
    """images01 [B, H, W, 3] in [0, 1] -> (tokens, pooled): ImageNet
    normalisation, then the bilinear resize to the trunk's input size."""
    b = images01.shape[0]
    x = imagenet_normalize(images01.float())
    size = model.image_size
    return model(resize(x, (b, size, size, 3)))


# trunk geometries of the reference's three factory families (ViT-B is the
# pipeline's; L and H load the same way)
OMNIMAE_VARIANTS = {
    "vit_base": dict(embed_dim=768, depth=12, num_heads=12,
                     patch_size=(2, 16, 16)),
    "vit_large": dict(embed_dim=1024, depth=24, num_heads=16,
                      patch_size=(2, 16, 16)),
    "vit_huge": dict(embed_dim=1280, depth=32, num_heads=16,
                     patch_size=(2, 14, 14)),
}


def infer_omnimae_variant(sd) -> str:
    """B, L or H from a trunk state dict: the patch Conv3d weight is
    [D, 3, pt, ph, pw] and the block count is in the keys."""
    keys = {k[len("trunk."):] if k.startswith("trunk.") else k: k
            for k in sd}
    conv_key = ("patch_embed.proj.1.weight"
                if "patch_embed.proj.1.weight" in keys
                else "patch_embed.proj.weight")
    w = sd[keys[conv_key]]
    dim, ph = int(w.shape[0]), int(w.shape[3])
    depth = 1 + max(int(k.split(".")[1]) for k in keys
                    if k.startswith("blocks."))
    for name, v in OMNIMAE_VARIANTS.items():
        if (v["embed_dim"], v["depth"], v["patch_size"][1]) == (dim, depth,
                                                                ph):
            return name
    raise ValueError(f"unrecognized OmniMAE trunk: dim={dim} depth={depth} "
                     f"patch={ph}")


def omnimae_vit(variant: str = "vit_base", **kw) -> OmniMAEViT:
    """The trunk of vit_{base,large,huge}_mae_pretraining."""
    return OmniMAEViT(**{**OMNIMAE_VARIANTS[variant], **kw})
