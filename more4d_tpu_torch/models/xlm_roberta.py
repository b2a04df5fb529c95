"""XLM-RoBERTa-large text tower, the CLIP text branch (PyTorch port of
``more4d_tpu/models/xlm_roberta.py``).

Token, type and position embeddings (the positions from a pad-aware
cumsum), post-norm attention blocks with the padding as an additive
attention bias, and ``XLMRobertaWithHead``'s average pool and MLP head
(wan_image_encoder.py:305-327). The pipelines read CLIP's vision side
only; the text side is part of the checkpoint and of CLIP's interface.

Parameter names are the reference torch module's (``blocks.N.attn.q``,
``blocks.N.ffn.0``, ``head.0``), so a checkpoint loads as it is and the
JAX package's ``convert_xlm_roberta_state_dict`` reads ``state_dict()``.
The attention is the plain fp32 einsum-softmax the JAX module computes.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import LayerNormF32, Linear

NEG_INF = torch.finfo(torch.float32).min


class RobertaAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        for name in ("q", "k", "v", "o"):
            setattr(self, name, Linear(dim, dim, dtype))

    def forward(self, x, bias):
        b, s, c = x.shape
        n = self.num_heads
        d = c // n
        q, k, v = (m(x).reshape(b, s, n, d) for m in (self.q, self.k, self.v))
        logits = torch.einsum("blnd,bmnd->bnlm", q.float(), k.float()) \
            * d ** -0.5
        p = torch.softmax(logits + bias, -1).to(v.dtype)
        o = torch.einsum("bnlm,bmnd->blnd", p, v).reshape(b, s, c)
        return self.o(o)


class RobertaBlock(nn.Module):
    """Attention and an exact-GELU MLP, each added back and normalised
    after (``post_norm``) or normalised before."""

    def __init__(self, dim: int, num_heads: int, post_norm: bool = True,
                 eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.post_norm = post_norm
        self.attn = RobertaAttention(dim, num_heads, dtype)
        self.norm1 = LayerNormF32(dim, eps=eps, cast_back=True)
        self.ffn = nn.Sequential(Linear(dim, 4 * dim, dtype),
                                 nn.GELU(approximate="none"),
                                 Linear(4 * dim, dim, dtype))
        self.norm2 = LayerNormF32(dim, eps=eps, cast_back=True)

    def forward(self, x, bias):
        if self.post_norm:
            x = self.norm1(x + self.attn(x, bias))
            return self.norm2(x + self.ffn(x))
        x = x + self.attn(self.norm1(x), bias)
        return x + self.ffn(self.norm2(x))


class XLMRoberta(nn.Module):
    """ids [B, S] (``pad_id`` marks padding) -> features [B, S, dim]."""

    def __init__(self, vocab_size: int = 250002, max_seq_len: int = 514,
                 type_size: int = 1, pad_id: int = 1, dim: int = 1024,
                 num_heads: int = 16, num_layers: int = 24,
                 post_norm: bool = True, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.pad_id, self.dim, self.post_norm = pad_id, dim, post_norm
        self.token_embedding = nn.Embedding(vocab_size, dim)
        self.type_embedding = nn.Embedding(type_size, dim)
        self.pos_embedding = nn.Embedding(max_seq_len, dim)
        self.norm = LayerNormF32(dim, eps=eps, cast_back=True)
        self.blocks = nn.ModuleList(
            RobertaBlock(dim, num_heads, post_norm, eps, dtype)
            for _ in range(num_layers))
        self.dtype = dtype

    def forward(self, ids):
        b, s = ids.shape
        mask = (ids != self.pad_id).long()
        pos_ids = self.pad_id + torch.cumsum(mask, dim=1) * mask
        x = (self.token_embedding(ids) + self.type_embedding(
            torch.zeros_like(ids)) + self.pos_embedding(pos_ids)).to(
            self.dtype)
        if self.post_norm:
            x = self.norm(x)
        bias = torch.where(mask.reshape(b, 1, 1, s) > 0, 0.0, NEG_INF).to(
            x.device)
        for blk in self.blocks:
            x = blk(x, bias)
        if not self.post_norm:
            x = self.norm(x)
        return x


class XLMRobertaWithHead(XLMRoberta):
    """The features averaged over the unpadded tokens, then an MLP head
    (no biases, exact GELU) to ``out_dim``."""

    def __init__(self, out_dim: int = 1024, **kw):
        super().__init__(**kw)
        mid = (self.dim + out_dim) // 2
        self.head = nn.Sequential(
            nn.Linear(self.dim, mid, bias=False),
            nn.GELU(approximate="none"),
            nn.Linear(mid, out_dim, bias=False))

    def forward(self, ids):
        x = super().forward(ids)
        mask = (ids != self.pad_id).to(x.dtype)[..., None]
        pooled = (x * mask).sum(1) / torch.clamp_min(mask.sum(1), 1e-6)
        return self.head(pooled)
