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
keeps the norm's rounding before the rotation.

K5's backward (:func:`rownorm_bwd_cuda`, the same source) takes each
epilogue's gradients in one pass over the rows from the bf16 x and output
gradient and the fp32 statistics the forward kept, a CTA a strip of rows
keeping the column sums (the norm's weight and bias, per-sample shift and
scale, the FiLM gate) in registers, then a short pass that adds up the
strips' sums in a fixed order. Its plain version,
:func:`rownorm_backward_plain`, writes the same mathematics out in fp32;
the backward treats the norm's bf16 rounding before the rotation as the
identity, as autograd treats a cast.

The dispatchers (:func:`rms_norm`, :func:`layer_norm_affine`,
:func:`modulate`) route a call by what its inputs show (:func:`_route`):
a CPU tensor runs the plain version; a CUDA tensor where autograd records
nothing (grad mode off, or no input requiring a gradient) launches K5;
a CUDA tensor where autograd records goes through :class:`RowNorm`, an
``autograd.Function`` (K5 keeping the statistics, its backward the
function's). Both raise where K5 cannot take the tensors; x of any
layout is made contiguous first (a sequence-parallel rank's tokens are a
strided cut of the batch).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, Iterable, Optional, Tuple

import torch

from . import _build

EPILOGUES = ("rms", "rope", "affine", "modulate", "film")
# the column sums of each epilogue's backward (csrc/rownorm.cu bwd_slots)
_SLOTS = {"rms": 1, "rope": 1, "affine": 2, "modulate": 2, "film": 3}
# the norm's weight or bias stored in bf16 (else fp32): K5's flags
_W_BF16, _B_BF16 = 1, 2

# (params [B, L, 2D] of the FiLM projection, mask [L, 1] or None, gate [D])
Film = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]
# the operands that take a gradient, by the names the backward gives them
GRAD_NAMES = ("x", "weight", "bias", "shift", "scale", "params", "gate")


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


def _layer_norm_epilogue(epilogue: str) -> bool:
    return epilogue in ("affine", "modulate", "film")


def row_stats(epilogue: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Each row's statistics as K5 keeps them for the backward: [rows, 2]
    (mean, rstd) for the LayerNorm epilogues, [rows, 1] rstd for rms and
    rope; fp32 (fp64 for an fp64 x)."""
    xf = x.reshape(-1, x.shape[-1]).to(torch.promote_types(x.dtype,
                                                           torch.float32))
    if not _layer_norm_epilogue(epilogue):
        return torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return torch.cat([mean, torch.rsqrt(var + eps)], -1)


def rownorm_backward_plain(epilogue: str, x: torch.Tensor,
                           dy: torch.Tensor, stats: torch.Tensor, *,
                           weight=None, bias=None, shift=None, scale=None,
                           film: Optional[Film] = None, cos=None, sin=None,
                           need: Iterable[str] = GRAD_NAMES
                           ) -> Dict[str, torch.Tensor]:
    """The plain version of :func:`rownorm_bwd_cuda`: the gradients of
    ``epilogue``'s output (gradient ``dy``) with respect to each operand
    named in ``need`` that the epilogue has, in fp32 (fp64 for an fp64 x)
    from ``stats`` (:func:`row_stats`), each in its operand's dtype and
    shape. With n the normalised row and g = dL/dn:

        rms       dweight = sum dy n,  g = dy w
        rope      the same with dy first turned back by each pair's -theta
        affine    dweight = sum dy n,  dbias = sum dy,  g = dy w
        modulate  dshift = dy, dscale = dy n (summed over L for per-sample
                  rows),  g = dy (1 + scale)
        film      with h the adaLN output and (ps, ph) the projection
                  times the mask: dgate = sum dy (h ps + ph),
                  dparams = dy gate mask (h | 1),  then modulate's
                  with dy (1 + ps gate)
        dx        rstd (g - mean(g) - n mean(g n)) (rms: no mean(g))
    """
    need = set(need)
    acc = torch.promote_types(x.dtype, torch.float32)
    d = x.shape[-1]
    st = stats.to(acc).reshape(*x.shape[:-1], -1)
    rstd = st[..., -1:]
    ln = _layer_norm_epilogue(epilogue)
    n = (x.to(acc) - st[..., :1]) * rstd if ln else x.to(acc) * rstd
    g_out = dy.to(acc)
    grads = {}

    def put(name, t, like):
        if name in need:
            grads[name] = t.sum_to_size(like.shape).to(like.dtype)

    if epilogue in ("rms", "rope", "affine"):
        if epilogue == "rope":
            b, l, _ = x.shape
            half = cos.shape[-1]
            gr = g_out.reshape(b, l, d // (2 * half), half, 2)
            c = cos.to(acc)[None, :, None]
            s = sin.to(acc)[None, :, None]
            e, o = gr[..., 0], gr[..., 1]
            g_out = torch.stack([e * c + o * s, o * c - e * s],
                                -1).reshape(b, l, d)
        put("weight", g_out * n, weight)
        if epilogue == "affine":
            put("bias", g_out, bias)
        gn = g_out * weight.to(acc)
    else:
        sc = scale.to(acc)
        if film is not None:
            params, mask, gate = film
            h = n * (1 + sc) + shift.to(acc)
            ps, ph = params.to(acc).chunk(2, -1)
            if mask is not None:
                m = mask.to(params.dtype).to(acc).reshape(1, -1, 1)
                ps, ph = ps * m, ph * m
            gt = gate.to(acc)
            put("gate", g_out * (h * ps + ph), gate)
            if "params" in need:
                dph = g_out * gt
                if mask is not None:
                    dph = dph * m
                grads["params"] = torch.cat([dph * h, dph],
                                            -1).to(params.dtype)
            g_out = g_out * (1 + ps * gt)
        put("shift", g_out, shift)
        put("scale", g_out * n, scale)
        gn = g_out * (1 + sc)
    if "x" in need:
        gm = gn.mean(-1, keepdim=True) if ln else 0
        grads["x"] = (rstd * (gn - gm - n * (gn * n).mean(-1, keepdim=True))
                      ).to(x.dtype)
    return grads


# ------------------------------------------------------------------ kernel

def _kernel():
    return _build.bind(
        "rownorm", "rownorm_bf16",
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_float]
        + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p])


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


def _launch_args(epilogue, x, weight, bias, shift, scale, film, cos, sin):
    """The operands of one K5 launch as its C entry points take them,
    checked: (rows, flags, {name: tensor}, the tokens a sample, the adaLN
    rows' strides, RoPE's half head dim)."""
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
    flags, ptrs = 0, {}
    length, mod_sb, mod_sl, half = 1, 0, 0, 0
    if rows == 0:
        return rows, flags, ptrs, length, mod_sb, mod_sl, half
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
    return rows, flags, ptrs, length, mod_sb, mod_sl, half


def _ptr(ptrs, name):
    t = ptrs.get(name)
    return None if t is None else t.data_ptr()


def rownorm_cuda(epilogue: str, x: torch.Tensor, eps: float, *,
                 weight=None, bias=None, shift=None, scale=None,
                 film: Optional[Film] = None, cos=None, sin=None,
                 stats: bool = False):
    """Launch K5 with ``epilogue`` (one of :data:`EPILOGUES`) over the rows
    of x, a contiguous bf16 CUDA tensor whose last dim D is a multiple of 8
    up to 8192; returns a new bf16 tensor of x's shape. ``weight`` [D]
    (rms, rope, affine), ``bias`` [D] (affine), ``shift``/``scale`` bf16
    broadcasting to x's [B, L, D] (modulate, film), ``film`` = (params
    [B, L, 2D] bf16, mask [L, 1] fp32 or None, gate [D] bf16), ``cos``/``sin``
    [L, head_dim/2] fp32 with head_dim a multiple of 8 dividing D (rope).
    With ``stats`` returns (output, each row's statistics as
    :func:`row_stats` gives them) for :func:`rownorm_bwd_cuda`, and
    shift/scale must be [B, 1, D] or [B, L, D] (the shapes the backward
    gives gradients of)."""
    rows, flags, ptrs, length, mod_sb, mod_sl, half = _launch_args(
        epilogue, x, weight, bias, shift, scale, film, cos, sin)
    kept = None
    if stats:
        _per_token(epilogue, x, shift, scale)
        kept = x.new_empty((rows, 2 if _layer_norm_epilogue(epilogue)
                            else 1), dtype=torch.float32)
    out = torch.empty_like(x)
    if rows == 0:
        return (out, kept) if stats else out
    err = _kernel()(EPILOGUES.index(epilogue), x.data_ptr(), out.data_ptr(),
                    rows, length, x.shape[-1], float(eps), _ptr(ptrs, "w"),
                    _ptr(ptrs, "b"), _ptr(ptrs, "shift"),
                    _ptr(ptrs, "scale"), mod_sb, mod_sl, _ptr(ptrs, "film"),
                    _ptr(ptrs, "mask"), _ptr(ptrs, "gate"),
                    _ptr(ptrs, "cos"), _ptr(ptrs, "sin"), half, flags,
                    None if kept is None else kept.data_ptr(),
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rownorm_bf16")
    rownorm_cuda.launches += 1
    rownorm_cuda.epilogues[epilogue] += 1
    return (out, kept) if stats else out


rownorm_cuda.launches = 0
rownorm_cuda.epilogues = collections.Counter()


def _per_token(epilogue, x, shift, scale) -> bool:
    """Whether the adaLN rows of a gradient call are per token ([B, L, D])
    rather than per sample ([B, 1, D]); raises for other shapes, whose
    gradients K5's backward does not take."""
    if epilogue not in ("modulate", "film"):
        return False
    b, l, d = x.shape
    if shift.shape != scale.shape or tuple(shift.shape) not in (
            (b, 1, d), (b, l, d)):
        _fail(f"a gradient needs shift and scale of one shape, {(b, 1, d)} "
              f"or {(b, l, d)}, got {tuple(shift.shape)} and "
              f"{tuple(scale.shape)}")
    return l > 1 and shift.shape[1] == l


def _bwd_kernel():
    return _build.bind(
        "rownorm", "rownorm_bwd_bf16",
        [ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        + [ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int,
                                                        ctypes.c_void_p])


def _bwd_occupancy(epi: int, d: int, per_token: bool) -> int:
    fn = _build.bind("rownorm", "rownorm_bwd_occupancy",
                     [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    _build.check(fn(epi, d, int(per_token), ctypes.byref(blocks)),
                 "rownorm_bwd_occupancy")
    return max(blocks.value, 1)


def bwd_strips(group_rows: int, groups: int, occupancy: int,
               sms: int) -> int:
    """The strips each group's rows are cut into for K5's backward: one
    wave of the card (``sms`` SMs, each holding ``occupancy`` CTAs) spread
    over the groups, every strip holding at least one row."""
    per = max(1, min(group_rows, -(-sms * occupancy // groups)))
    return -(-group_rows // -(-group_rows // per))


@functools.lru_cache(maxsize=None)
def _strips(epi: int, d: int, per_token: bool, group_rows: int, groups: int,
            device: int) -> int:
    """:func:`bwd_strips` on card ``device`` for a backward's shape."""
    return bwd_strips(group_rows, groups, _bwd_occupancy(epi, d, per_token),
                      torch.cuda.get_device_properties(
                          device).multi_processor_count)


def rownorm_bwd_cuda(epilogue: str, x: torch.Tensor, dy: torch.Tensor,
                     stats: torch.Tensor, *, weight=None, bias=None,
                     shift=None, scale=None, film: Optional[Film] = None,
                     cos=None, sin=None, need: Iterable[str] = GRAD_NAMES
                     ) -> Dict[str, torch.Tensor]:
    """Launch K5's backward for ``epilogue``: x and the operands as
    :func:`rownorm_cuda` took them, ``dy`` the bf16 gradient of its output,
    ``stats`` the statistics it kept. Returns {name: gradient} for each
    name of ``need`` (:data:`GRAD_NAMES`) the epilogue has, each in its
    operand's dtype and shape; the arguments and results of
    :func:`rownorm_backward_plain`."""
    rows, flags, ptrs, length, mod_sb, mod_sl, half = _launch_args(
        epilogue, x, weight, bias, shift, scale, film, cos, sin)
    if dy.shape != x.shape or dy.dtype != torch.bfloat16 or not dy.is_cuda:
        _fail(f"dy must be a bf16 CUDA tensor {tuple(x.shape)}")
    kept = (rows, 2 if _layer_norm_epilogue(epilogue) else 1)
    if (stats.shape != kept or stats.dtype != torch.float32
            or not stats.is_cuda or not stats.is_contiguous()):
        _fail(f"stats must be the forward's contiguous fp32 CUDA {kept}")
    need = set(need)
    grads = {}
    if rows == 0:
        return grads
    dy = dy.contiguous()
    d = x.shape[-1]
    epi = EPILOGUES.index(epilogue)
    per_token = _per_token(epilogue, x, shift, scale)
    modulated = epilogue in ("modulate", "film")
    groups = x.shape[0] if modulated and not per_token else 1

    def new(name, *shape, dtype=torch.bfloat16):
        if name not in need:
            return None
        grads[name] = x.new_empty(shape, dtype=dtype)
        return grads[name]

    dx = new("x", *x.shape)
    dshift = dscale = dfilm = None
    sums, sum_bf16 = [None] * 3, 0
    if epilogue in ("rms", "rope", "affine"):
        names = ("weight", "bias")[:2 if epilogue == "affine" else 1]
        for q, name in enumerate(names):
            read = ptrs["w" if q == 0 else "b"]
            sums[q] = new(name, d, dtype=read.dtype)
            sum_bf16 |= (read.dtype == torch.bfloat16) << q
    elif per_token:
        dshift, dscale = new("shift", *x.shape), new("scale", *x.shape)
    else:
        sums[0] = new("shift", groups, 1, d)
        sums[1] = new("scale", groups, 1, d)
        sum_bf16 |= 3
    if epilogue == "film":
        dfilm = new("params", *x.shape[:2], 2 * d)
        sums[2] = new("gate", d)
        sum_bf16 |= 4
    partial = None
    slots = sum(t is not None for t in sums)
    strips = _strips(epi, d, per_token, rows // groups, groups,
                     x.get_device())
    if slots:
        partial = x.new_empty((groups, strips, _SLOTS[epilogue], d),
                              dtype=torch.float32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _bwd_kernel()(
        epi, x.data_ptr(), dy.data_ptr(), stats.data_ptr(), ptr(dx), rows,
        length, groups, strips, d, _ptr(ptrs, "w"), _ptr(ptrs, "shift"),
        _ptr(ptrs, "scale"), mod_sb, mod_sl, int(per_token),
        _ptr(ptrs, "film"), _ptr(ptrs, "mask"), _ptr(ptrs, "gate"),
        _ptr(ptrs, "cos"), _ptr(ptrs, "sin"), half, flags, ptr(dshift),
        ptr(dscale), ptr(dfilm), ptr(partial), *map(ptr, sums), sum_bf16,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rownorm_bwd_bf16")
    rownorm_bwd_cuda.launches += 1
    rownorm_bwd_cuda.epilogues[epilogue] += 1
    # a norm vector K5 read widened (not bf16 or fp32) takes its own dtype
    for name, t in (("weight", weight), ("bias", bias)):
        if name in grads and grads[name].dtype != t.dtype:
            grads[name] = grads[name].to(t.dtype)
    return grads


rownorm_bwd_cuda.launches = 0
rownorm_bwd_cuda.epilogues = collections.Counter()


# --------------------------------------------------- the gradient's function

def _operand_kw(weight, bias, shift, scale, params, mask, gate, cos, sin):
    return dict(weight=weight, bias=bias, shift=shift, scale=scale,
                film=None if params is None else (params, mask, gate),
                cos=cos, sin=sin)


# RowNorm's inputs after x and eps, by name
_OPERANDS = ("weight", "bias", "shift", "scale", "params", "mask", "gate",
             "cos", "sin")


class RowNorm(torch.autograd.Function):
    """K5 (its plain version for CPU tensors) where autograd records, with
    K5's backward as its backward: one node of the graph a norm site
    (``RowNormBackward`` in a trace), keeping each row's statistics
    (:func:`row_stats`) for the backward. ``apply(epilogue, x, eps,
    weight, bias, shift, scale, params, mask, gate, cos, sin)``, the FiLM
    operands apart; the mask and the RoPE rows take no gradient. A plain
    ``autograd.Function`` rather than a ``torch.library.custom_op``: a
    remat'd fine-tune step applies it 16 times a block (the forward and its
    rerun), and the function is the lighter binding on the host.
    The checkpoint's policies see no op inside it, so every policy reruns
    it in the backward."""

    @staticmethod
    def forward(ctx, epilogue, x, eps, weight, bias, shift, scale, params,
                mask, gate, cos, sin):
        kw = _operand_kw(weight, bias, shift, scale, params, mask, gate,
                         cos, sin)
        if x.is_cuda:
            out, stats = rownorm_cuda(epilogue, x, eps, stats=True, **kw)
        else:
            out = rownorm_plain(epilogue, x, eps, **kw)
            stats = row_stats(epilogue, x, eps)
        ctx.epilogue = epilogue
        ctx.save_for_backward(x, stats, weight, bias, shift, scale, params,
                              mask, gate, cos, sin)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, stats, *operands = ctx.saved_tensors
        _, need_x, _, *need_ops = ctx.needs_input_grad
        need = {n for n, on in zip(_OPERANDS, need_ops) if on}
        if need & {"mask", "cos", "sin"}:
            raise NotImplementedError("K5's backward gives the FiLM mask and "
                                      "the RoPE rows no gradient")
        if need_x:
            need.add("x")
        bwd = rownorm_bwd_cuda if x.is_cuda else rownorm_backward_plain
        grads = bwd(ctx.epilogue, x, dy, stats, need=need,
                    **_operand_kw(*operands))
        return (None, grads.get("x"), None,
                *(grads.get(n) for n in _OPERANDS))


# ------------------------------------------------------------- dispatchers

PLAIN, KERNEL, GRAD = "plain", "kernel", "grad"


def _route(x, *more) -> str:
    """The code that takes a call, by what its inputs show: PLAIN for a
    CPU tensor; KERNEL (K5 launched directly) for a CUDA tensor where
    autograd records nothing (grad mode off, or no input requiring a
    gradient); GRAD (:class:`RowNorm`, K5 and its backward) for a CUDA
    tensor where autograd records."""
    if not x.is_cuda:
        return PLAIN
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, *more)):
        return GRAD
    return KERNEL


def _grad(epilogue, x, eps, weight=None, bias=None, shift=None, scale=None,
          film: Optional[Film] = None, cos=None, sin=None):
    """K5 with ``epilogue`` through :class:`RowNorm`, on a contiguous x."""
    params, mask, gate = (None, None, None) if film is None else film
    return RowNorm.apply(epilogue, x.contiguous(), eps, weight, bias, shift,
                         scale, params, mask, gate, cos, sin)


def rms_norm(x, weight, eps: float, dtype: torch.dtype, cos=None, sin=None):
    """RMSNorm of x over its last dim times ``weight``, in ``dtype``; with
    ``cos``/``sin`` [L, head_dim/2] x is [B, L, D] and each head of the
    result is rotated by RoPE (:func:`rms_norm_rope_plain`)."""
    route = _route(x, weight, cos, sin)
    if route == PLAIN:
        if cos is None:
            return rms_norm_plain(x, weight, eps, dtype)
        return rms_norm_rope_plain(x, weight, eps, dtype, cos, sin)
    if dtype != torch.bfloat16:
        _fail(f"the result must be bf16, not {dtype}")
    epilogue = "rms" if cos is None else "rope"
    if route == KERNEL:
        return rownorm_cuda(epilogue, x.contiguous(), eps, weight=weight,
                            cos=cos, sin=sin)
    return _grad(epilogue, x, eps, weight=weight, cos=cos, sin=sin)


def layer_norm_affine(x, weight, bias, eps: float):
    """``layer_norm(x, eps, weight, bias)``."""
    route = _route(x, weight, bias)
    if route == PLAIN:
        return layer_norm(x, eps, weight, bias)
    if route == KERNEL:
        return rownorm_cuda("affine", x.contiguous(), eps, weight=weight,
                            bias=bias)
    return _grad("affine", x, eps, weight=weight, bias=bias)


def modulate(x, eps: float, shift, scale, film: Optional[Film] = None):
    """:func:`modulate_plain`: the adaLN modulation of x [B, L, D] and,
    with ``film`` = (params, mask, gate), its FiLM."""
    more = () if film is None else film
    route = _route(x, shift, scale, *more)
    if route == PLAIN:
        return modulate_plain(x, eps, shift, scale, film)
    epilogue = "modulate" if film is None else "film"
    if route == KERNEL:
        return rownorm_cuda(epilogue, x.contiguous(), eps, shift=shift,
                            scale=scale, film=film)
    return _grad(epilogue, x, eps, shift=shift, scale=scale, film=film)
