"""fp8 weights widened for their products: the hand-written Hopper kernel
(K6) and its plain PyTorch version.

K6 (``csrc/widen.cu``) replaces no TPU kernel: the JAX package's fp8
kernels are promoted inside the XLA graph, where the cast fuses into the
product's read. The port widens each weight ``utils/quantize.py`` stores
in ``float8_e4m3fn`` once a forward (``nn.layers.compute_param``): to bf16
for the DiT's products, to fp32 for its time embedding. PyTorch's cast
kernel runs at about a quarter of the card's bandwidth there, K6 near it
(loads of what one 16-byte store takes, the hardware's e4m3 decode). Both
give the same bits: every finite e4m3 value is exact in bf16 and fp32, and
the scaled variant rounds the fp32 product ``float(q) * scale`` once to
bf16, as the plain version does.

:func:`widen_fp8` routes a call by where the weight lives: K6 on the card,
the plain version on the host. K6 takes every fp8 weight the port keeps on
the card (contiguous, frozen, its scale beside it) and raises on anything
else rather than hand it to the plain cast.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

FP8 = torch.float8_e4m3fn
_F32 = {torch.bfloat16: 0, torch.float32: 1}   # K6's output types


def widen_fp8_plain(p: torch.Tensor, dtype: torch.dtype,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``p`` (fp8) in ``dtype``: with ``scale``, first scaled back in fp32
    and rounded to bf16, as the JAX package's ``dequantize_params`` gives
    it to flax."""
    if scale is not None:
        p = (p.float() * scale).to(torch.bfloat16)
    return p.to(dtype)


def _kernel():
    return _build.bind("widen", "widen_fp8",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def _fail(what):
    raise ValueError(f"widen_fp8_cuda: {what}")


def widen_fp8_cuda(p: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
                   scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K6 on ``p``, a contiguous ``float8_e4m3fn`` CUDA tensor at any
    offset that records no gradient, on the current stream: a new tensor of
    p's shape in ``dtype``, bf16 or fp32 (through ``scale``, an fp32 scalar
    on p's card, where given). Counts its launches and the fp8 bytes they
    read. Raises ValueError for any other operands."""
    f32 = _F32.get(dtype)
    if f32 is None:
        _fail(f"widens to bf16 or fp32, not {dtype}")
    if not p.is_cuda or p.dtype != FP8 or not p.is_contiguous():
        _fail(f"p must be a contiguous float8_e4m3fn CUDA tensor, got "
              f"{p.dtype} on {p.device}")
    if p.requires_grad:
        _fail("p records a gradient, which K6's output would not carry")
    if scale is not None and (scale.device != p.device
                              or scale.dtype != torch.float32
                              or scale.numel() != 1):
        _fail(f"the scale must be one fp32 value on {p.device}")
    # ~1,200 calls a 14B forward: the raw stream handle and empty_like
    # cost the host ~3 us where current_stream() and empty(shape) cost ~15
    out = torch.empty_like(p, dtype=dtype)
    n = p.numel()
    if n == 0:
        return out
    err = _kernel()(p.data_ptr(), out.data_ptr(), n, f32,
                    None if scale is None else scale.data_ptr(),
                    torch._C._cuda_getCurrentRawStream(p.get_device()))
    _build.check(err, "widen_fp8")
    widen_fp8_cuda.launches += 1
    widen_fp8_cuda.bytes += n
    return out


widen_fp8_cuda.launches = 0
widen_fp8_cuda.bytes = 0


def widen_fp8(p: torch.Tensor, dtype: torch.dtype,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``p`` (fp8) in ``dtype``, as :func:`widen_fp8_plain` gives it: by
    K6 on the card, by the plain version on the host."""
    if p.is_cuda:
        return widen_fp8_cuda(p, dtype, scale)
    return widen_fp8_plain(p, dtype, scale)
