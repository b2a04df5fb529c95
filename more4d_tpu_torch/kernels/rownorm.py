"""Row norms of the DiT block and the elementwise chains that follow them:
the hand-written Hopper kernel (K5) and its plain PyTorch versions.

K5 (``csrc/rownorm.cu``) replaces no TPU kernel: the JAX package leaves
these chains to XLA, which fuses each into one pass over a token's row,
where PyTorch's eager code runs every step of a chain as its own kernel.
One launch reads each row once and writes it once, with one of five
epilogues:

    rms       RMSNorm times its weight (the cross-attention's q, k, k_img)
    rope      the same, rounded to bf16, then each head's consecutive
              channel pairs rotated by the token's cos/sin row
              (the self-attention's q and k)
    affine    LayerNorm times weight plus bias (``norm3``)
    modulate  LayerNorm * (1 + scale) + shift (the adaLN sites without
              motion guidance)
    film      modulate, then the FiLM of ``SpatialGuidance``:
              h * (1 + scale * gate) + shift * gate, (scale, shift) its
              projection's output times the token mask

The plain versions are the eager code as the modules ran it; the kernel
keeps fp32 from the statistics to the store where the eager chain rounds
to bf16 after every operation (fewer rounding points, never more), and
keeps the norm's rounding before the rotation. The dispatchers
(:func:`rms_norm`, :func:`layer_norm_affine`, :func:`modulate`) launch K5
on a CUDA tensor where autograd would record nothing (grad mode off, or no
input requiring a gradient), raising where K5 cannot take the tensors; x
of any layout is made contiguous first (a sequence-parallel rank's tokens
are a strided cut of the batch). A call that carries a gradient, and any
CPU tensor, runs the plain version.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from . import _build

EPILOGUES = ("rms", "rope", "affine", "modulate", "film")
# the norm's weight or bias stored in bf16 (else fp32): K5's flags
_W_BF16, _B_BF16 = 1, 2

# (params [B, L, 2D] of the FiLM projection, mask [L, 1] or None, gate [D])
Film = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]


# ------------------------------------------------------------ plain versions

def layer_norm(x, eps: float = 1e-6, weight=None, bias=None):
    """Layer norm in fp32, cast back to x's dtype (WanLayerNorm)."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate q/k by precomputed angles.

    x: [B, L, H, D]; cos/sin: [L, D//2]. Pairs are consecutive (even, odd)
    channels; the rotation runs in float32 and casts back.
    """
    dtype = x.dtype
    b, l, n, d = x.shape
    xr = x.float().reshape(b, l, n, d // 2, 2)
    xe, xo = xr[..., 0], xr[..., 1]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    oe = xe * c - xo * s
    oo = xe * s + xo * c
    return torch.stack([oe, oo], dim=-1).reshape(b, l, n, d).to(dtype)


def rms_norm_plain(x, weight, eps: float, dtype: torch.dtype):
    """RMS norm over the last dim in fp32, times ``weight``, cast to
    ``dtype`` (WanRMSNorm)."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (normed * weight.float()).to(dtype)


def rms_norm_rope_plain(x, weight, eps: float, dtype: torch.dtype, cos,
                        sin):
    """:func:`rms_norm_plain` of x [B, L, D], then :func:`apply_rope` on its
    heads of 2 * cos.shape[-1] channels; [B, L, D]."""
    y = rms_norm_plain(x, weight, eps, dtype)
    b, l, d = y.shape
    hd = 2 * cos.shape[-1]
    return apply_rope(y.reshape(b, l, d // hd, hd), cos, sin).reshape(b, l, d)


def film_plain(x, params, mask, gate):
    """FiLM of x by the projection's output ``params`` [B, L, 2D] (zero
    where ``mask`` [L, 1] is 0) and the gate [D] (``SpatialGuidance``)."""
    if mask is not None:
        params = params * mask[None].to(params.dtype)
    scale, shift = params.chunk(2, dim=-1)
    return x * (1 + scale * gate) + shift * gate


def modulate_plain(x, eps: float, shift, scale, film: Optional[Film] = None):
    """adaLN: ``layer_norm(x) * (1 + scale) + shift``, then the FiLM
    ``film`` = (params, mask, gate) where given."""
    h = layer_norm(x, eps) * (1 + scale) + shift
    return h if film is None else film_plain(h, *film)


def rownorm_plain(epilogue: str, x: torch.Tensor, eps: float, *,
                  weight=None, bias=None, shift=None, scale=None,
                  film: Optional[Film] = None, cos=None, sin=None
                  ) -> torch.Tensor:
    """The plain version of :func:`rownorm_cuda`'s ``epilogue``, with the
    same arguments (the result in bf16)."""
    if epilogue == "rms":
        return rms_norm_plain(x, weight, eps, torch.bfloat16)
    if epilogue == "rope":
        return rms_norm_rope_plain(x, weight, eps, torch.bfloat16, cos, sin)
    if epilogue == "affine":
        return layer_norm(x, eps, weight, bias)
    return modulate_plain(x, eps, shift, scale,
                          film if epilogue == "film" else None)


# ------------------------------------------------------------------ kernel

def _kernel():
    return _build.bind(
        "rownorm", "rownorm_bf16",
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_float]
        + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p])


MAX_DIM = 8192      # 4 chunks of 8 a thread, 256 threads a row


def _fail(what):
    raise ValueError(f"rownorm_cuda: {what}")


def _aligned(x, what):
    if x.data_ptr() % 16:
        _fail(f"{what} must start on a 16-byte boundary")


def _norm_vector(t, d, what) -> Tuple[torch.Tensor, bool]:
    """A norm's [D] weight or bias as K5 reads it: bf16 or fp32 as stored,
    any other float type widened with ``.float()`` as the plain version
    widens it. Returns (tensor, stored in bf16)."""
    if not t.is_cuda or t.shape != (d,):
        _fail(f"{what} must be a [{d}] CUDA tensor, got "
              f"{tuple(t.shape)} on {t.device}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        t = t.float()
    t = t.contiguous()
    _aligned(t, what)
    return t, t.dtype == torch.bfloat16


def _rows(t, b, l, d, what) -> Tuple[int, int]:
    """The strides (a sample, a token) of bf16 adaLN rows broadcast to
    [B, L, D] without a copy."""
    if not t.is_cuda or t.dtype != torch.bfloat16:
        _fail(f"{what} must be a bf16 CUDA tensor")
    try:
        sb, sl, sd = t.expand(b, l, d).stride()
    except RuntimeError:
        _fail(f"{what} of shape {tuple(t.shape)} does not broadcast to "
              f"{(b, l, d)}")
    if sd != 1 or sb % 8 or sl % 8:
        _fail(f"{what} needs a contiguous last dim and 16-byte aligned rows")
    _aligned(t, what)
    return sb, sl


def rownorm_cuda(epilogue: str, x: torch.Tensor, eps: float, *,
                 weight=None, bias=None, shift=None, scale=None,
                 film: Optional[Film] = None, cos=None, sin=None
                 ) -> torch.Tensor:
    """Launch K5 with ``epilogue`` (one of :data:`EPILOGUES`) over the rows
    of x, a contiguous bf16 CUDA tensor whose last dim D is a multiple of 8
    up to 8192; returns a new bf16 tensor of x's shape. ``weight`` [D]
    (rms, rope, affine), ``bias`` [D] (affine), ``shift``/``scale`` bf16
    broadcasting to x's [B, L, D] (modulate, film), ``film`` = (params
    [B, L, 2D] bf16, mask [L, 1] fp32 or None, gate [D] bf16), ``cos``/``sin``
    [L, head_dim/2] fp32 with head_dim a multiple of 8 dividing D (rope)."""
    if epilogue not in EPILOGUES:
        _fail(f"unknown epilogue {epilogue!r}")
    if not x.is_cuda or x.dtype != torch.bfloat16:
        _fail(f"x must be a bf16 CUDA tensor, got {x.dtype} on {x.device}")
    if not x.is_contiguous() or x.dim() < 2:
        _fail("x must be contiguous with at least two dims")
    _aligned(x, "x")
    d = x.shape[-1]
    if d % 8 or not 8 <= d <= MAX_DIM:
        _fail(f"width {d} is not a multiple of 8 from 8 to {MAX_DIM}")
    rows = x.numel() // d
    if rows == 0:
        return torch.empty_like(x)
    flags, ptrs = 0, {}
    length, mod_sb, mod_sl, half = 1, 0, 0, 0
    if epilogue in ("rms", "rope", "affine"):
        w, bf = _norm_vector(weight, d, "weight")
        ptrs["w"], flags = w, flags | (_W_BF16 if bf else 0)
    if epilogue == "affine":
        b, bf = _norm_vector(bias, d, "bias")
        ptrs["b"], flags = b, flags | (_B_BF16 if bf else 0)
    if epilogue in ("rope", "modulate", "film"):
        if x.dim() != 3:
            _fail(f"{epilogue} takes x as [B, L, D], got {tuple(x.shape)}")
        length = x.shape[1]
    if epilogue == "rope":
        if (cos is None or sin is None or cos.shape != sin.shape
                or cos.dim() != 2 or cos.shape[0] != length):
            _fail(f"rope needs cos and sin [L={length}, head_dim/2]")
        half = cos.shape[1]
        if half % 4 or d % (2 * half):
            _fail(f"head dim {2 * half} must be a multiple of 8 dividing {d}")
        for name, t in (("cos", cos), ("sin", sin)):
            if (not t.is_cuda or t.dtype != torch.float32
                    or not t.is_contiguous()):
                _fail(f"{name} must be a contiguous fp32 CUDA tensor")
            _aligned(t, name)
        ptrs["cos"], ptrs["sin"] = cos, sin
    if epilogue in ("modulate", "film"):
        mod_sb, mod_sl = _rows(shift, x.shape[0], length, d, "shift")
        if _rows(scale, x.shape[0], length, d, "scale") != (mod_sb, mod_sl):
            _fail("shift and scale must share a layout")
        ptrs["shift"], ptrs["scale"] = shift, scale
    if epilogue == "film":
        params, mask, gate = film
        if (not params.is_cuda or params.dtype != torch.bfloat16
                or params.shape != (*x.shape[:2], 2 * d)
                or not params.is_contiguous()):
            _fail(f"the FiLM projection must be a contiguous bf16 CUDA "
                  f"tensor {(*x.shape[:2], 2 * d)}")
        _aligned(params, "the FiLM projection")
        ptrs["film"] = params
        if mask is not None:
            if (not mask.is_cuda or mask.dtype != torch.float32
                    or mask.numel() != length):
                _fail(f"the mask must be an fp32 CUDA tensor of {length} "
                      f"tokens")
            ptrs["mask"] = mask.contiguous()
        if (not gate.is_cuda or gate.dtype != torch.bfloat16
                or gate.shape != (d,)):
            _fail(f"the gate must be a [{d}] bf16 CUDA tensor")
        ptrs["gate"] = gate.contiguous()
        _aligned(ptrs["gate"], "the gate")

    def ptr(name):
        t = ptrs.get(name)
        return None if t is None else t.data_ptr()

    out = torch.empty_like(x)
    err = _kernel()(EPILOGUES.index(epilogue), x.data_ptr(), out.data_ptr(),
                    rows, length, d, float(eps), ptr("w"), ptr("b"),
                    ptr("shift"), ptr("scale"), mod_sb, mod_sl, ptr("film"),
                    ptr("mask"), ptr("gate"), ptr("cos"), ptr("sin"), half,
                    flags, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rownorm_bf16")
    rownorm_cuda.launches += 1
    rownorm_cuda.epilogues[epilogue] += 1
    return out


rownorm_cuda.launches = 0
rownorm_cuda.epilogues = collections.Counter()


# ------------------------------------------------------------- dispatchers

def _runs_kernel(x, *more) -> bool:
    """K5 takes the call: x is a CUDA tensor and autograd would record
    nothing (grad mode off, or no input requiring a gradient)."""
    if not x.is_cuda:
        return False
    return not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, *more)))


def rms_norm(x, weight, eps: float, dtype: torch.dtype, cos=None, sin=None):
    """RMSNorm of x over its last dim times ``weight``, in ``dtype``; with
    ``cos``/``sin`` [L, head_dim/2] x is [B, L, D] and each head of the
    result is rotated by RoPE (:func:`rms_norm_rope_plain`)."""
    if not _runs_kernel(x, weight, cos, sin):
        if cos is None:
            return rms_norm_plain(x, weight, eps, dtype)
        return rms_norm_rope_plain(x, weight, eps, dtype, cos, sin)
    if dtype != torch.bfloat16:
        _fail(f"the result must be bf16, not {dtype}")
    if cos is None:
        return rownorm_cuda("rms", x.contiguous(), eps, weight=weight)
    return rownorm_cuda("rope", x.contiguous(), eps, weight=weight, cos=cos,
                        sin=sin)


def layer_norm_affine(x, weight, bias, eps: float):
    """``layer_norm(x, eps, weight, bias)``."""
    if not _runs_kernel(x, weight, bias):
        return layer_norm(x, eps, weight, bias)
    return rownorm_cuda("affine", x.contiguous(), eps, weight=weight,
                        bias=bias)


def modulate(x, eps: float, shift, scale, film: Optional[Film] = None):
    """:func:`modulate_plain`: the adaLN modulation of x [B, L, D] and,
    with ``film`` = (params, mask, gate), its FiLM."""
    more = () if film is None else film
    if not _runs_kernel(x, shift, scale, *more):
        return modulate_plain(x, eps, shift, scale, film)
    if film is None:
        return rownorm_cuda("modulate", x.contiguous(), eps, shift=shift,
                            scale=scale)
    return rownorm_cuda("film", x.contiguous(), eps, shift=shift,
                        scale=scale, film=film)
