"""umT5-xxl text encoder (PyTorch port of ``more4d_tpu/models/t5.py``).

The reference's from-scratch T5: attention with no 1/sqrt(d) scaling,
float32 scores plus a bidirectional relative-position bias (one table per
block when ``shared_pos`` is False, as umT5-xxl has it), keys masked with
float32's minimum, a GEGLU feed-forward with the tanh GELU on the gate, and
RMS-style ``T5LayerNorm``s in float32 (eps 1e-6). Inference only.

Module and parameter names are the released
``models_t5_umt5-xxl-enc-bf16.pth``'s (``blocks.N.attn.q``,
``blocks.N.ffn.gate.0``, ``blocks.N.pos_embedding.embedding``), so that
state dict loads as is. The attention stays plain matmul and softmax: the
flash kernel takes neither the bias nor the missing scale, and the JAX
package runs it as XLA einsums too.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import T5Config
from ..nn.layers import Linear, dense_attention


class T5LayerNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight in float32, cast to ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (self.weight.float() * y).to(self.dtype)


def relative_position_buckets(lq: int, lk: int, num_buckets: int,
                              bidirectional: bool = True,
                              max_dist: int = 128) -> np.ndarray:
    """T5 relative position bucketing, [lq, lk] int64 (a copy of the JAX
    package's numpy function)."""
    rel_pos = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    if bidirectional:
        nb = num_buckets // 2
        rel_buckets = (rel_pos > 0).astype(np.int64) * nb
        rel_pos = np.abs(rel_pos)
    else:
        nb = num_buckets
        rel_buckets = np.zeros_like(rel_pos)
        rel_pos = -np.minimum(rel_pos, 0)
    max_exact = nb // 2
    with np.errstate(divide="ignore"):
        large = max_exact + (
            np.log(np.maximum(rel_pos, 1) / max_exact)
            / math.log(max_dist / max_exact) * (nb - max_exact)
        ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return rel_buckets + np.where(rel_pos < max_exact, rel_pos, large)


class T5RelativeEmbedding(nn.Module):
    """The [1, H, Lq, Lk] position bias from a [num_buckets, H] table,
    looked up at ``relative_position_buckets`` (bidirectional, max
    distance 128), which the encoder computes once a forward."""

    def __init__(self, num_buckets: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Embedding(num_buckets, num_heads)

    def forward(self, buckets: torch.Tensor):
        bias = self.embedding.weight[buckets]                # [Lq, Lk, H]
        return bias.permute(2, 0, 1)[None].to(self.dtype)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        for name, (i, o) in (("q", (cfg.dim, cfg.dim_attn)),
                             ("k", (cfg.dim, cfg.dim_attn)),
                             ("v", (cfg.dim, cfg.dim_attn)),
                             ("o", (cfg.dim_attn, cfg.dim))):
            setattr(self, name, Linear(i, o, cfg.dtype, bias=False))

    def forward(self, x, mask=None, pos_bias=None):
        cfg = self.cfg
        b, l, _ = x.shape
        shape = (b, l, cfg.num_heads, cfg.dim_attn // cfg.num_heads)
        o = dense_attention(self.q(x).reshape(shape),
                            self.k(x).reshape(shape),
                            self.v(x).reshape(shape), bias=pos_bias,
                            mask=mask)
        return self.o(o.reshape(b, l, cfg.dim_attn))


class T5FeedForward(nn.Module):
    """GEGLU: fc1(x) * gelu_tanh(gate(x)) -> fc2."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gate = nn.Sequential(
            Linear(cfg.dim, cfg.dim_ffn, cfg.dtype, bias=False),
            nn.GELU(approximate="tanh"))
        self.fc1 = Linear(cfg.dim, cfg.dim_ffn, cfg.dtype, bias=False)
        self.fc2 = Linear(cfg.dim_ffn, cfg.dim, cfg.dtype, bias=False)

    def forward(self, x):
        return self.fc2(self.fc1(x) * self.gate(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.norm1 = T5LayerNorm(cfg.dim, dtype=cfg.dtype)
        self.attn = T5Attention(cfg)
        self.norm2 = T5LayerNorm(cfg.dim, dtype=cfg.dtype)
        self.ffn = T5FeedForward(cfg)
        if not cfg.shared_pos:
            self.pos_embedding = T5RelativeEmbedding(
                cfg.num_buckets, cfg.num_heads, cfg.dtype)

    def forward(self, x, buckets, mask=None, pos_bias=None):
        if not self.cfg.shared_pos:
            pos_bias = self.pos_embedding(buckets)
        x = x + self.attn(self.norm1(x), mask, pos_bias)
        return x + self.ffn(self.norm2(x))


class WanT5Encoder(nn.Module):
    """input_ids [B, L] (int), attention_mask [B, L] (1 = token) ->
    hidden states [B, L, dim] in ``cfg.dtype``."""

    def __init__(self, cfg: T5Config = T5Config()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab, cfg.dim)
        if cfg.shared_pos:
            self.pos_embedding = T5RelativeEmbedding(
                cfg.num_buckets, cfg.num_heads, cfg.dtype)
        self.blocks = nn.ModuleList(T5Block(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = T5LayerNorm(cfg.dim, dtype=cfg.dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "WanT5Encoder":
        """T5's initialisation (the reference's ``init_weights``): token
        embedding N(0, 1); q N(0, (dim * dim_attn)^-1/2), k and v
        N(0, dim^-1/2), o N(0, (heads * dim_attn)^-1/2); gate and fc1
        N(0, dim^-1/2), fc2 N(0, dim_ffn^-1/2); position tables
        N(0, (2 * buckets * heads)^-1/2); norm scales one."""
        cfg = self.cfg
        std = {"token_embedding": 1.0,
               "attn.q": (cfg.dim * cfg.dim_attn) ** -0.5,
               "attn.k": cfg.dim ** -0.5, "attn.v": cfg.dim ** -0.5,
               "attn.o": (cfg.num_heads * cfg.dim_attn) ** -0.5,
               "ffn.gate.0": cfg.dim ** -0.5, "ffn.fc1": cfg.dim ** -0.5,
               "ffn.fc2": cfg.dim_ffn ** -0.5,
               "pos_embedding.embedding": (2 * cfg.num_buckets
                                           * cfg.num_heads) ** -0.5}
        for name, p in self.named_parameters():
            key = next((k for k in std if name.endswith(k + ".weight")), None)
            if key is None:                                 # norm scales
                p.fill_(1.0)
            else:
                p.normal_(0.0, std[key], generator=generator)
        return self

    def forward(self, input_ids,
                attention_mask: Optional[torch.Tensor] = None):
        cfg = self.cfg
        x = self.token_embedding(input_ids).to(cfg.dtype)
        length = x.shape[1]
        buckets = torch.from_numpy(relative_position_buckets(
            length, length, cfg.num_buckets)).to(x.device)
        pos_bias = self.pos_embedding(buckets) if cfg.shared_pos else None
        for blk in self.blocks:
            x = blk(x, buckets, attention_mask, pos_bias)
        return self.norm(x)
