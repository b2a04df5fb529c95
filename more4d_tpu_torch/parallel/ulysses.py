"""Ulysses sequence-parallel attention (PyTorch port of
``more4d_tpu/parallel/ulysses.py``).

The reference chunks the DiT's tokens across ranks
(wan_transformer4d.py:1187-1198), swaps the sequence and head dims around
self-attention with an all-to-all, and all-gathers the output
(:1320-1321). Here each rank holds its L/S tokens (``WanDiT.backbone``
takes its slice) and

  [B, L/S, H, D] --all_to_all--> [B, L, H/S, D] --attn--> --all_to_all-->
  [B, L/S, H, D]

Only self-attention communicates: the cross-attention's context is the
same on every rank. Both all-to-alls are differentiable, the backward of
each being the other, as JAX's ``shard_map`` version is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import AXIS_SEQ, mesh_shape

_ACTIVE_MESH = None


def set_mesh(mesh) -> None:
    """Install a process-wide mesh used by sequence-parallel attention."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh():
    return _ACTIVE_MESH


def seq_parallel_size() -> int:
    if _ACTIVE_MESH is None:
        return 1
    return mesh_shape(_ACTIVE_MESH).get(AXIS_SEQ, 1)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all over dim 0 of ``x`` [S, ...]: row j goes to rank j, and
    row j of the result came from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x: torch.Tensor, group, s: int) -> torch.Tensor:
    """[B, L/S, H, D] -> [B, L, H/S, D]: send head group j to rank j,
    concatenate the ranks' sequence chunks in rank order."""
    b, ls, h, d = x.shape
    y = _all_to_all(x.reshape(b, ls, s, h // s, d).permute(2, 0, 1, 3, 4),
                    group)                              # [S, B, L/S, H/S, D]
    return y.permute(1, 0, 2, 3, 4).reshape(b, s * ls, h // s, d)


def _heads_to_seq(x: torch.Tensor, group, s: int) -> torch.Tensor:
    """[B, L, H/S, D] -> [B, L/S, H, D], the inverse of ``_seq_to_heads``."""
    b, l, hs, d = x.shape
    y = _all_to_all(x.reshape(b, s, l // s, hs, d).permute(1, 0, 2, 3, 4),
                    group)                              # [S, B, L/S, H/S, D]
    return y.permute(1, 2, 0, 3, 4).reshape(b, l // s, s * hs, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, s):
        ctx.group, ctx.s = group, s
        return _seq_to_heads(x, group, s)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group, ctx.s), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, s):
        ctx.group, ctx.s = group, s
        return _heads_to_seq(x, group, s)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group, ctx.s), None, None


def ulysses_attention(attn_fn, q, k, v, kv_lens=None, mesh=None,
                      axis: str = AXIS_SEQ):
    """Run ``attn_fn(q, k, v, kv_lens)`` on this rank's sequence chunk.

    q/k/v: [B, L/S, H, D], the rank's chunk of the sequence in rank order
    along ``axis``; ``kv_lens`` counts keys of the whole sequence, the same
    on every rank. Requires H % S == 0. Returns [B, L/S, H, D]."""
    mesh = mesh or _ACTIVE_MESH
    size = mesh_shape(mesh)[axis]
    if size == 1:
        return attn_fn(q, k, v, kv_lens)
    h = q.shape[2]
    if h % size:
        raise ValueError(f"Ulysses attention: {h} heads do not split over "
                         f"{size} ranks of the {axis!r} axis")
    group = mesh.get_group(axis)
    qg, kg, vg = (_SeqToHeads.apply(t, group, size) for t in (q, k, v))
    return _HeadsToSeq.apply(attn_fn(qg, kg, vg, kv_lens), group, size)
