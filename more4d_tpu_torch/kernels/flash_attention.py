"""Flash attention, forward and backward: the hand-written Hopper kernels
(K1 forward, K2 dq, K3 dk/dv) and their plain PyTorch versions.

Replaces ``more4d_tpu/kernels/flash_attention.py``: K1 ``_flash_fwd_kernel``
(:48, host ``_flash_forward`` :125), K2 ``_flash_bwd_dq_kernel`` (:216) and
K3 ``_flash_bwd_dkv_kernel`` (:250, host ``_flash_backward`` :291). The
kernels are ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``;
what bounds them and how they are built is noted there. Both versions
compute, with the JAX package's rounding points:

    q' = bf16(q * bf16(sm_scale * log2 e))       (q's dtype, as JAX folds it)
    s  = q' k^T  (fp32), keys at or past kv_lens[b] masked to -1e30
    forward:   m = rowmax(s), p = exp2(s - m), l = rowsum(p)
               o = (p in v's dtype) v / max(l, 1e-30)      (in q's dtype)
               lse = m + log2(max(l, 1e-30))     (fp32, base 2, [B*H, Lq])
    backward:  p = exp2(s - lse), dp = dO v^T, delta = rowsum(dO * O)
               ds = p * (dp - delta) * sm_scale
               dq = (ds in k's dtype) k
               dv = (p in dO's dtype)^T dO
               dk = (ds in q's dtype)^T q' / (log2 e * sm_scale)

``flash_attention`` takes BLHD tensors like the JAX entry point. Where a
gradient is needed it runs through ``flash_attn_op``, a
``torch.library.custom_op`` whose autograd saves (q, k, v, o, lse) and whose
backward runs K2 and K3 (a remat policy can keep its outputs for the
backward, as the JAX package names them inside its custom VJP);
otherwise it calls the forward alone. K1 forms q' once a q tile; the backward forms q' once (:func:`scaled_q`) for both kernels, and K3
splits its q loop across CTAs where its key tiles alone would not fill the
card (:func:`dkv_splits`). A CUDA tensor launches the kernels (bf16, head
dim 64 or 128) or raises; a CPU tensor runs the plain versions.
An empty key set returns zeros, as JAX does, and gives q, k and v no
gradient. A row whose ``kv_lens[b]`` is 0 has no defined output.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634

# K3's tiles (csrc/flash_attention_bwd.cu BM, BN): the q-split counts in them.
# The library reports its own, and binding K3 fails if they differ.
DKV_BLOCK_K = 64
DKV_BLOCK_Q = 64
DKV_MAX_SPLITS = 16
DKV_REDUCE_COST = 2     # the split's second pass, in q-tile times


def _q_scale(sm_scale: float, dtype: torch.dtype) -> float:
    """sm_scale*log2e rounded to q's dtype, as the JAX host folds it."""
    return float(torch.tensor(sm_scale * LOG2E, dtype=dtype))


def scaled_q(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """q' = q * bf16(sm_scale * log2 e) in q's dtype, formed once on the
    host as JAX ``_flash_backward`` forms it (:319). A product of two bf16
    values is exact in fp32, so this is the q' the kernels staged."""
    return q * torch.tensor(_q_scale(sm_scale, q.dtype), dtype=q.dtype,
                            device=q.device)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dkv_splits(b: int, h: int, lq: int, lk: int, sms: int) -> int:
    """How many CTAs share each of K3's key tiles, each over its own
    contiguous range of q tiles. One CTA a key tile where those CTAs fill
    two a SM. Otherwise 1 or at least enough splits to fill them, chosen
    to minimise the waves of CTAs times the q tiles each walks (plus one
    for its prologue and epilogue, plus DKV_REDUCE_COST for the second
    pass of a split), at most DKV_MAX_SPLITS. The result is trimmed so
    that no split is empty (see :func:`split_ranges`)."""
    key_ctas = _cdiv(lk, DKV_BLOCK_K) * b * h
    slots = 2 * sms
    nq = _cdiv(lq, DKV_BLOCK_Q)
    if key_ctas >= slots:
        return 1

    def cost(s):
        return (_cdiv(key_ctas * s, slots) * (_cdiv(nq, s) + 1)
                + (DKV_REDUCE_COST if s > 1 else 0))

    lo = min(_cdiv(slots, key_ctas), nq)
    hi = max(lo, min(nq, DKV_MAX_SPLITS))
    s = min([1, *range(lo, hi + 1)], key=lambda s: (cost(s), s))
    return _cdiv(nq, _cdiv(nq, s))


def split_ranges(lq: int, splits: int):
    """The q rows [start, stop) of each split: ceil(nq / splits) q tiles
    each, the last one short."""
    nq = _cdiv(lq, DKV_BLOCK_Q)
    per = _cdiv(nq, splits)
    return [(min(lq, s * per * DKV_BLOCK_Q),
             min(lq, (s + 1) * per * DKV_BLOCK_Q)) for s in range(splits)]


def _kernel():
    return _build.bind(
        "flash_attention", "flash_fwd_bf16",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
           ctypes.c_void_p])


def flash_fwd_tiles() -> Tuple[int, int]:
    """K1's tiles as its library reports them (``csrc/flash_attention.cu``
    BQ, BK): (q rows a CTA, keys a tile of its loop). Key tiles past
    ``kv_lens[b]`` are skipped whole, so a check that drops the last key
    tile needs BK. Builds the library if needed."""
    tile = _build.bind("flash_attention", "flash_fwd_tile", [ctypes.c_int])
    bq, bk = tile(0), tile(1)
    if bq % 64 or bk not in (64, 128):
        raise RuntimeError(f"K1 reports {bq} q rows x {bk} keys a tile; "
                           f"csrc/flash_attention.cu takes multiples of 64 "
                           f"rows and 64 or 128 keys")
    return bq, bk


def _dq_kernel():
    return _build.bind(
        "flash_attention_bwd", "flash_bwd_dq_bf16",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
           ctypes.c_void_p])


def _dkv_kernel():
    fn = _build.bind(
        "flash_attention_bwd", "flash_bwd_dkv_bf16",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float,
           ctypes.c_void_p])
    if not _dkv_kernel.tiles_checked:
        tile = _build.bind("flash_attention_bwd", "flash_bwd_dkv_tile",
                           [ctypes.c_int])
        if (tile(0), tile(1)) != (DKV_BLOCK_K, DKV_BLOCK_Q):
            raise RuntimeError(
                f"K3's tiles are {tile(0)} keys x {tile(1)} q rows in "
                f"csrc/flash_attention_bwd.cu, but DKV_BLOCK_K/DKV_BLOCK_Q "
                f"say {DKV_BLOCK_K} x {DKV_BLOCK_Q}")
        _dkv_kernel.tiles_checked = True
    return fn


_dkv_kernel.tiles_checked = False


def _scores(q, k, kv_lens, sm_scale):
    """(q' in q's dtype, s [B, H, Lq, Lk] fp32 with masked keys at -1e30)."""
    lk = k.shape[1]
    qs = scaled_q(q, sm_scale)
    s = torch.einsum("blhd,bmhd->bhlm", qs.float(), k.float())
    if kv_lens is not None:
        keep = (torch.arange(lk, device=q.device)[None, :]
                < kv_lens.to(q.device)[:, None])
        s = s.masked_fill(~keep[:, None, None, :], NEG_INF)
    return qs, s


def flash_attention_plain(q, k, v, kv_lens=None, sm_scale=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch. q [B,Lq,H,D], k/v
    [B,Lk,H,D], kv_lens [B] int32 or None -> (o [B,Lq,H,D] in q's dtype,
    lse [B*H, Lq] fp32)."""
    b, lq, h, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    _, s = _scores(q, k, kv_lens, sm_scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhlm,bmhd->blhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    lse = (m + torch.log2(l)).reshape(b * h, lq)
    return o.to(q.dtype), lse


def _delta(o, do):
    """rowsum(dO * O) in fp32 as [B*H, Lq] (JAX computes it outside its
    kernels too, ``_flash_backward`` :321-325)."""
    b, lq, h, _ = o.shape
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(b * h,
                                                                      lq)


def _bwd_terms(q, k, v, kv_lens, o, lse, do, sm_scale):
    """(q', p, ds) of the backward, [B, H, Lq, Lk] fp32 for p and ds."""
    b, lq, h, _ = q.shape
    qs, s = _scores(q, k, kv_lens, sm_scale)
    p = torch.exp2(s - lse.reshape(b, h, lq, 1))
    dp = torch.einsum("blhd,bmhd->bhlm", do.float(), v.float())
    delta = _delta(o, do).reshape(b, h, lq, 1)
    return qs, p, p * (dp - delta) * sm_scale


def flash_attention_bwd_plain(q, k, v, kv_lens, o, lse, do, sm_scale=None
                              ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' function in plain PyTorch: (dq, dk, dv) of the
    attention output o (with its base-2 lse [B*H, Lq]) against the output
    gradient do, each in its input's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qs, p, ds = _bwd_terms(q, k, v, kv_lens, o, lse, do, sm_scale)
    dq = torch.einsum("bhlm,bmhd->blhd", ds.to(k.dtype).float(), k.float())
    dv = torch.einsum("bhlm,blhd->bmhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhlm,blhd->bmhd", ds.to(q.dtype).float(), qs.float())
    dk = dk * (1.0 / (LOG2E * sm_scale))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dkv_split_plain(q, k, v, kv_lens, o, lse, do, splits,
                              sm_scale=None) -> Tuple[torch.Tensor, ...]:
    """K3's q-split in plain PyTorch: (dk, dv) as the fp32 partial sums of
    each split's q rows (:func:`split_ranges`), added in split order, dk
    divided by log2 e * sm_scale once, each rounded once."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qs, p, ds = _bwd_terms(q, k, v, kv_lens, o, lse, do, sm_scale)
    dk = dv = 0.0
    for start, stop in split_ranges(q.shape[1], splits):
        dv = dv + torch.einsum("bhlm,blhd->bmhd",
                               p[:, :, start:stop].to(do.dtype).float(),
                               do[:, start:stop].float())
        dk = dk + torch.einsum("bhlm,blhd->bmhd",
                               ds[:, :, start:stop].to(q.dtype).float(),
                               qs[:, start:stop].float())
    dk = dk * (1.0 / (LOG2E * sm_scale))
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_bf16_blhd(fn, name, x):
    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError(f"{fn}: {name} must be a bf16 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    if x.dim() != 4 or x.stride(-1) != 1:
        raise ValueError(f"{fn}: {name} must be [B, L, H, D] with a "
                         f"contiguous last dim")
    if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} strides and address must be 16-byte "
                         f"aligned")


def _check_inputs(fn, q, k, v, kv_lens, **more):
    """Raise on what the kernels do not take; returns kv_lens contiguous."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    for name, x in dict(q=q, k=k, v=v, **more).items():
        _check_bf16_blhd(fn, name, x)
    if d not in (64, 128):
        raise ValueError(f"{fn}: head dim {d} is not supported (64 or 128)")
    if k.shape != (b, lk, h, d) or v.shape != k.shape or any(
            x.shape != q.shape for x in more.values()):
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if kv_lens is not None:
        if (not kv_lens.is_cuda or kv_lens.dtype != torch.int32
                or kv_lens.shape != (b,)):
            raise ValueError(f"{fn}: kv_lens must be a [B] int32 CUDA tensor")
        kv_lens = kv_lens.contiguous()
    return kv_lens


def _strides(*xs):
    return (ctypes.c_longlong * (3 * len(xs)))(
        *[s for x in xs for s in x.stride()[:3]])


def _ptr(x):
    return None if x is None else x.data_ptr()


def _rows(x, b, h, lq, what):
    """An fp32 [B*H, Lq] per-row vector on x's device, or raise."""
    if x.dtype != torch.float32 or x.shape != (b * h, lq) or not x.is_cuda:
        raise ValueError(f"{what} must be a [B*H, Lq] fp32 CUDA tensor")
    return x.contiguous()


def flash_attention_cuda(q, k, v, kv_lens=None, sm_scale=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the K1 kernel. Same arguments and results as
    :func:`flash_attention_plain`; q/k/v bf16 CUDA tensors with a
    contiguous head dim of 64 or 128."""
    b, lq, h, d = q.shape
    kv_lens = _check_inputs("flash_attention_cuda", q, k, v, kv_lens)
    # K1 reads q, k and v through TMA maps, which cannot describe a
    # broadcast (stride 0) dimension
    q, k, v = (x.contiguous() if any(s == 0 and n > 1 for s, n in zip(
        x.stride()[:3], x.shape[:3])) else x for x in (q, k, v))
    if sm_scale is None:
        sm_scale = d ** -0.5
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), _ptr(kv_lens), b, h, lq, k.shape[1], d,
                    _strides(q, k, v, o), _q_scale(sm_scale, q.dtype),
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd_bf16")
    flash_attention_cuda.launches += 1
    return o, lse


flash_attention_cuda.launches = 0


def flash_bwd_dq_cuda(qp, k, v, kv_lens, do, lse, delta, sm_scale=None
                      ) -> torch.Tensor:
    """Launch the K2 kernel: dq [B,Lq,H,D] bf16, given q' (:func:`scaled_q`),
    dO, the forward's base-2 lse and delta = rowsum(dO * O) ([B*H, Lq] fp32
    each)."""
    b, lq, h, d = qp.shape
    kv_lens = _check_inputs("flash_bwd_dq_cuda", qp, k, v, kv_lens, do=do)
    lse, delta = (_rows(x, b, h, lq, f"flash_bwd_dq_cuda: {n}")
                  for n, x in (("lse", lse), ("delta", delta)))
    if sm_scale is None:
        sm_scale = d ** -0.5
    dq = torch.empty_like(qp, memory_format=torch.contiguous_format)
    err = _dq_kernel()(qp.data_ptr(), k.data_ptr(), v.data_ptr(),
                       do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                       dq.data_ptr(), _ptr(kv_lens), b, h, lq, k.shape[1], d,
                       _strides(qp, k, v, do, dq), sm_scale,
                       torch.cuda.current_stream(qp.device).cuda_stream)
    _build.check(err, "flash_bwd_dq_bf16")
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_bwd_dkv_cuda(qp, k, v, kv_lens, do, lse, delta, sm_scale=None,
                       splits=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the K3 kernel: (dk, dv) [B,Lk,H,D] bf16; keys at or past
    kv_lens[b] get exact zeros. Arguments as :func:`flash_bwd_dq_cuda`.
    ``splits`` CTAs share each key tile (default :func:`dkv_splits` for
    this card); above 1 they write fp32 partials into a workspace that a
    second kernel sums in split order."""
    b, lq, h, d = qp.shape
    lk = k.shape[1]
    kv_lens = _check_inputs("flash_bwd_dkv_cuda", qp, k, v, kv_lens, do=do)
    lse, delta = (_rows(x, b, h, lq, f"flash_bwd_dkv_cuda: {n}")
                  for n, x in (("lse", lse), ("delta", delta)))
    if sm_scale is None:
        sm_scale = d ** -0.5
    if splits is None:
        splits = dkv_splits(b, h, lq, lk, _sm_count(qp.device))
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    ws = None
    if splits > 1:
        ws = torch.empty((2, splits, b * h, lk, d), dtype=torch.float32,
                         device=qp.device)
    err = _dkv_kernel()(qp.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), _ptr(kv_lens), _ptr(ws),
                        b, h, lq, lk, d, splits,
                        _strides(qp, k, v, do, dk, dv), sm_scale,
                        1.0 / (LOG2E * sm_scale),
                        torch.cuda.current_stream(qp.device).cuda_stream)
    _build.check(err, "flash_bwd_dkv_bf16")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, kv_lens, o, lse, do, sm_scale=None
                             ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) through K2 and K3, with q' formed once here. Same
    arguments and results as :func:`flash_attention_bwd_plain`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qp = scaled_q(q, sm_scale)
    delta = _delta(o, do)
    dq = flash_bwd_dq_cuda(qp, k, v, kv_lens, do, lse, delta, sm_scale)
    dk, dv = flash_bwd_dkv_cuda(qp, k, v, kv_lens, do, lse, delta, sm_scale)
    return dq, dk, dv


@torch.library.custom_op("more4d_torch::flash_attn", mutates_args=())
def flash_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_lens: Optional[torch.Tensor], sm_scale: Optional[float],
                  name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 (its plain version for CPU tensors) as a dispatcher op with K2
    and K3 as its backward. ``name`` names the call for a remat policy
    ("sa" for a DiT's self-attention, "" otherwise): a policy that keeps
    ``<name>_o`` keeps (o, lse) in the forward and gives them back in the
    backward's run instead of launching K1 again (``nn/remat.py``)."""
    from ..nn.remat import kept

    fwd = flash_attention_cuda if q.is_cuda else flash_attention_plain
    if not name:
        return fwd(q, k, v, kv_lens, sm_scale)
    return kept(f"{name}_o", lambda: fwd(q, k, v, kv_lens, sm_scale))


@flash_attn_op.register_fake
def _(q, k, v, kv_lens, sm_scale, name):
    b, lq, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b * h, lq), dtype=torch.float32))


def _flash_attn_setup(ctx, inputs, output):
    q, k, v, kv_lens, sm_scale, _ = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse, kv_lens)
    ctx.sm_scale = sm_scale


def _flash_attn_backward(ctx, do, _dlse):
    q, k, v, o, lse, kv_lens = ctx.saved_tensors
    bwd = (flash_attention_bwd_cuda if q.is_cuda
           else flash_attention_bwd_plain)
    dq, dk, dv = bwd(q, k, v, kv_lens, o, lse, do.contiguous(), ctx.sm_scale)
    return dq, dk, dv, None, None, None


flash_attn_op.register_autograd(_flash_attn_backward,
                                setup_context=_flash_attn_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_lens: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None,
                    name: str = "") -> torch.Tensor:
    """Attention over [B, L, H, D] tensors. kv_lens: optional [B] int32 —
    keys at positions >= kv_lens[b] are masked. ``name``: the call's name
    for a remat policy (see :func:`flash_attn_op`)."""
    if k.shape[1] == 0:
        # empty key set (an i2v cross-attention without clip context):
        # softmax over zero keys gives zeros, as the JAX entry point does
        return torch.zeros_like(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attn_op(q, k, v, kv_lens, sm_scale, name)[0]
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, kv_lens, sm_scale)[0]
    return flash_attention_plain(q, k, v, kv_lens, sm_scale)[0]
