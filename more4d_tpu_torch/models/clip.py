"""CLIP ViT-H/14 image encoder (PyTorch port of
``more4d_tpu/models/clip.py``), the vision tower of open-clip's
XLM-RoBERTa-large + ViT-H/14.

The pipelines read CLIP's 257 penultimate visual tokens: the tower holds
``num_layers - 1`` blocks (31 of 32) and no final norm or head. Pre-norm
blocks with a fused qkv and exact GELU, float32 layer norms (eps 1e-5) cast
back, a patch conv with no bias, learned cls and position embeddings.
Parameter names are the reference checkpoint's under ``visual.`` with the
prefix dropped (``transformer.N.attn.to_qkv``, ``transformer.N.mlp.0``);
``infer.encoders.build_clip_encoder`` takes them from a whole checkpoint.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import CLIPVisionConfig
from ..nn.layers import (Conv2d, LayerNormF32, Linear, dense_attention,
                         lecun_init_)
from ..nn.resize import resize

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(images: torch.Tensor, image_size: int = 224):
    """[B, H, W, 3] in [-1, 1] -> bicubic resize to image_size^2 (the JAX
    resize, antialiased), then to [0, 1] and the CLIP normalisation."""
    b = images.shape[0]
    x = resize(images.float(), (b, image_size, image_size, 3), "cubic")
    x = x * 0.5 + 0.5
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


class _ClipAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.to_qkv = Linear(cfg.dim, 3 * cfg.dim, cfg.dtype)
        self.proj = Linear(cfg.dim, cfg.dim, cfg.dtype)

    def forward(self, x):
        b, l, c = x.shape
        n, d = self.num_heads, c // self.num_heads
        q, k, v = (t.reshape(b, l, n, d)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        return self.proj(dense_attention(q, k, v, d ** -0.5).reshape(b, l, c))


class ClipBlock(nn.Module):
    """Pre-norm attention block with a fused qkv and an exact-GELU MLP."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        hidden = int(cfg.dim * cfg.mlp_ratio)
        self.norm1 = LayerNormF32(cfg.dim, eps=1e-5, cast_back=True)
        self.attn = _ClipAttention(cfg)
        self.norm2 = LayerNormF32(cfg.dim, eps=1e-5, cast_back=True)
        self.mlp = nn.Sequential(Linear(cfg.dim, hidden, cfg.dtype),
                                 nn.GELU(),
                                 Linear(hidden, cfg.dim, cfg.dtype))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ClipVisionTower(nn.Module):
    """x [B, image_size, image_size, 3] (preprocessed) -> the penultimate
    tokens [B, 1 + patches, dim] (cls first)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        patches = (cfg.image_size // p) ** 2
        self.patch_embedding = Conv2d(3, cfg.dim, p, stride=p, bias=False,
                                      dtype=cfg.dtype)
        self.cls_embedding = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, patches + 1,
                                                      cfg.dim))
        self.pre_norm = LayerNormF32(cfg.dim, eps=1e-5, cast_back=True)
        self.transformer = nn.ModuleList(ClipBlock(cfg)
                                         for _ in range(cfg.num_layers - 1))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ClipVisionTower":
        """flax's defaults (``lecun_init_``); cls and position embeddings
        N(0, dim^-1/2) as the JAX tower initialises them."""
        lecun_init_(self, generator)
        for p in (self.cls_embedding, self.pos_embedding):
            p.normal_(0.0, self.cfg.dim ** -0.5, generator=generator)
        return self

    def forward(self, x):
        cfg = self.cfg
        b = x.shape[0]
        h = self.patch_embedding(x.permute(0, 3, 1, 2))
        h = h.flatten(2).transpose(1, 2)                      # [B, P, dim]
        cls = self.cls_embedding.expand(b, 1, cfg.dim).to(h.dtype)
        h = torch.cat([cls, h], dim=1) + self.pos_embedding.to(h.dtype)
        h = self.pre_norm(h)
        for blk in self.transformer:
            h = blk(h)
        return h


def encode_image(tower: ClipVisionTower, images: torch.Tensor):
    """images [B, H, W, 3] in [-1, 1] -> [B, 257, 1280] context tokens."""
    return tower(clip_preprocess(images, tower.cfg.image_size))
