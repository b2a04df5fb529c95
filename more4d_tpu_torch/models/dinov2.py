"""DINOv2 ViT (patch 14) backbone (PyTorch port of
``more4d_tpu/models/dinov2.py``), the encoder of the UniDepth-V2 depth
model.

The official facebookresearch/dinov2 ViT: a conv patch embed, a cls token,
learned position embeddings resized bicubically (the JAX resize,
antialiased) to the input's patch grid, pre-norm blocks with LayerScale
and an exact-GELU MLP, a final layer norm (eps 1e-6 throughout).
``get_intermediate_layers`` is the dinov2 call UniDepth makes. Parameter
names are the official checkpoint's (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.N.attn.qkv``, ``blocks.N.ls1.gamma``, ``norm``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Set, Tuple

import torch
from torch import nn

from ..nn.layers import Conv2d, LayerNormF32, lecun_init_
from ..nn.resize import resize
from .omnimae import ViTBlock


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class DinoBlock(ViTBlock):
    """A ViT block whose two branches are scaled by LayerScale (ls1, ls2)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__(dim, num_heads, mlp_ratio, eps, dtype)
        self.ls1 = LayerScale(dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoV2ViT(nn.Module):
    """DINOv2 ViT-L/14 by default (dim 1024, 24 layers, 16 heads), with a
    37x37 position grid (518 / 14, the pretraining size)."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, patch_size: int = 14,
                 pos_grid: int = 37, mlp_ratio: float = 4.0,
                 eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.patch_size, self.pos_grid = (embed_dim,
                                                          patch_size,
                                                          pos_grid)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv2d(3, embed_dim, patch_size,
                                       stride=patch_size, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1,
                                                  embed_dim))
        self.blocks = nn.ModuleList(DinoBlock(embed_dim, num_heads, mlp_ratio,
                                              eps, dtype)
                                    for _ in range(depth))
        self.norm = LayerNormF32(embed_dim, eps, cast_back=True)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DinoV2ViT":
        """flax's defaults (``lecun_init_``), LayerScale one, cls token and
        position embeddings N(0, 0.02), as the JAX module initialises
        them."""
        lecun_init_(self, generator)
        for name, p in self.named_parameters():
            if name.endswith(".gamma"):
                p.fill_(1.0)
        for p in (self.cls_token, self.pos_embed):
            p.normal_(0.0, 0.02, generator=generator)
        return self

    def _interp_pos(self, gh: int, gw: int):
        """(cls position [1, 1, C], patch positions [1, gh*gw, C]) in
        float32, the patch table resized bicubically to the grid."""
        pos = self.pos_embed.float()
        cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
        if gh == self.pos_grid and gw == self.pos_grid:
            return cls_pos, patch_pos
        g, c = self.pos_grid, self.embed_dim
        patch_pos = resize(patch_pos.reshape(1, g, g, c), (1, gh, gw, c),
                           "cubic")
        return cls_pos, patch_pos.reshape(1, gh * gw, c)

    def _embed(self, x):
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        tokens = self.patch_embed.proj(x.permute(0, 3, 1, 2))
        tokens = tokens.flatten(2).transpose(1, 2)
        cls_pos, patch_pos = self._interp_pos(gh, gw)
        cls = (self.cls_token.expand(b, 1, self.embed_dim).to(tokens.dtype)
               + cls_pos.to(tokens.dtype))
        tokens = tokens + patch_pos.to(tokens.dtype)
        return torch.cat([cls, tokens], dim=1), (gh, gw)

    def forward(self, x):
        """x [B, H, W, 3] normalised -> (final-norm tokens [B, 1+N, C], cls
        first; the patch grid)."""
        h, grid = self._embed(x)
        for blk in self.blocks:
            h = blk(h)
        return self.norm(h), grid

    def get_intermediate_layers(self, x, layer_ids: Sequence[int]):
        """The final-normed tokens after each block in ``layer_ids``, as a
        list of (patch tokens [B, N, C], cls [B, C]) in ascending block
        order, and the patch grid. Blocks past the last one asked for do
        not run."""
        h, grid = self._embed(x)
        wanted = sorted(set(int(i) for i in layer_ids))
        outs = []
        for i, blk in enumerate(self.blocks[:wanted[-1] + 1]):
            h = blk(h)
            if i in wanted:
                t = self.norm(h)
                outs.append((t[:, 1:], t[:, 0]))
        return outs, grid


def official_names(sd: Dict[str, torch.Tensor], depth: int
                   ) -> Tuple[Dict[str, torch.Tensor], Set[str]]:
    """A DINOv2 backbone state dict under the official names (what
    ``DinoV2ViT`` holds), from a checkpoint under either the official names
    or the ``transformers`` ``Dinov2Model`` names, key by key as the JAX
    package's ``convert_dinov2_state_dict`` reads them (its q, k and v
    concatenated into ``attn.qkv``). Returns (state dict, the checkpoint
    keys read); a key found under neither name is left out, for the caller
    to report."""
    out: Dict[str, torch.Tensor] = {}
    consumed: Set[str] = set()

    def get(official, *names):
        for n in (official,) + names:
            if n in sd:
                consumed.add(n)
                out[official] = sd[n]
                return

    get("patch_embed.proj.weight",
        "embeddings.patch_embeddings.projection.weight")
    get("patch_embed.proj.bias", "embeddings.patch_embeddings.projection.bias")
    get("cls_token", "embeddings.cls_token")
    get("pos_embed", "embeddings.position_embeddings")
    for p in ("weight", "bias"):
        get(f"norm.{p}", f"layernorm.{p}")
    for i in range(depth):
        o, t = f"blocks.{i}", f"encoder.layer.{i}"
        for p in ("weight", "bias"):
            get(f"{o}.norm1.{p}", f"{t}.norm1.{p}")
            get(f"{o}.attn.proj.{p}", f"{t}.attention.output.dense.{p}")
            get(f"{o}.norm2.{p}", f"{t}.norm2.{p}")
            get(f"{o}.mlp.fc1.{p}", f"{t}.mlp.fc1.{p}")
            get(f"{o}.mlp.fc2.{p}", f"{t}.mlp.fc2.{p}")
            qkv = [f"{t}.attention.attention.{n}.{p}"
                   for n in ("query", "key", "value")]
            if f"{o}.attn.qkv.{p}" in sd:
                get(f"{o}.attn.qkv.{p}")
            elif all(k in sd for k in qkv):
                consumed.update(qkv)
                out[f"{o}.attn.qkv.{p}"] = torch.cat([sd[k] for k in qkv])
        get(f"{o}.ls1.gamma", f"{t}.layer_scale1.lambda1")
        get(f"{o}.ls2.gamma", f"{t}.layer_scale2.lambda1")
    return out, consumed
