"""Flash-attention forward: the hand-written Hopper kernel (K1) and its
plain PyTorch version.

Replaces ``more4d_tpu/kernels/flash_attention.py:48 _flash_fwd_kernel``
(host ``_flash_forward`` :125). The kernel is ``csrc/flash_attention.cu``;
what bounds it and how it is built is noted there. Both versions compute:

    q' = bf16(q * bf16(sm_scale * log2 e))       (q's dtype, as JAX folds it)
    s  = q' k^T  (fp32), keys at or past kv_lens[b] masked to -1e30
    m  = rowmax(s), p = exp2(s - m), l = rowsum(p)
    o  = (p in v's dtype) v / max(l, 1e-30)      (in q's dtype)
    lse = m + log2(max(l, 1e-30))                 (fp32, base 2, [B*H, Lq])

``flash_attention`` takes BLHD tensors like the JAX entry point. A CUDA
tensor launches the kernel (bf16, head dim 64 or 128) or raises; a CPU
tensor runs the plain version. An empty key set returns zeros, as JAX does.
A row whose ``kv_lens[b]`` is 0 has no defined output.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _q_scale(sm_scale: float, dtype: torch.dtype) -> float:
    """sm_scale*log2e rounded to q's dtype, as the JAX host folds it."""
    return float(torch.tensor(sm_scale * LOG2E, dtype=dtype))


def _kernel():
    return _build.bind(
        "flash_attention", "flash_fwd_bf16",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
           ctypes.c_void_p])


def flash_attention_plain(q, k, v, kv_lens=None, sm_scale=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch. q [B,Lq,H,D], k/v
    [B,Lk,H,D], kv_lens [B] int32 or None -> (o [B,Lq,H,D] in q's dtype,
    lse [B*H, Lq] fp32)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    qs = q * torch.tensor(_q_scale(sm_scale, q.dtype), dtype=q.dtype,
                          device=q.device)
    s = torch.einsum("blhd,bmhd->bhlm", qs.float(), k.float())
    if kv_lens is not None:
        keep = (torch.arange(lk, device=q.device)[None, :]
                < kv_lens.to(q.device)[:, None])
        s = s.masked_fill(~keep[:, None, None, :], NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhlm,bmhd->blhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    lse = (m + torch.log2(l)).reshape(b * h, lq)
    return o.to(q.dtype), lse


def flash_attention_cuda(q, k, v, kv_lens=None, sm_scale=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the K1 kernel. Same arguments and results as
    :func:`flash_attention_plain`; q/k/v bf16 CUDA tensors with a
    contiguous head dim of 64 or 128."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention_cuda: {name} must be a bf16 "
                             f"CUDA tensor, got {x.dtype} on {x.device}")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             f"[B, L, H, D] with a contiguous last dim")
        if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} strides and "
                             f"address must be 16-byte aligned")
    if d not in (64, 128):
        raise ValueError(f"flash_attention_cuda: head dim {d} is not "
                         f"supported (64 or 128)")
    if k.shape != (b, lk, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if kv_lens is not None:
        if (not kv_lens.is_cuda or kv_lens.dtype != torch.int32
                or kv_lens.shape != (b,)):
            raise ValueError("flash_attention_cuda: kv_lens must be a [B] "
                             "int32 CUDA tensor")
        kv_lens = kv_lens.contiguous()
    if sm_scale is None:
        sm_scale = d ** -0.5
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(),
             None if kv_lens is None else kv_lens.data_ptr(),
             b, h, lq, lk, d, strides, _q_scale(sm_scale, q.dtype),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd_bf16")
    flash_attention_cuda.launches += 1
    return o, lse


flash_attention_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_lens: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over [B, L, H, D] tensors. kv_lens: optional [B] int32 —
    keys at positions >= kv_lens[b] are masked."""
    if k.shape[1] == 0:
        # empty key set (an i2v cross-attention without clip context):
        # softmax over zero keys gives zeros, as the JAX entry point does
        return torch.zeros_like(q)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, kv_lens, sm_scale)[0]
    return flash_attention_plain(q, k, v, kv_lens, sm_scale)[0]
