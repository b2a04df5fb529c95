"""The table of kernel kinds: a device kernel's kind by its name (a frozen
copy of the port's profile table in ``chip_smoke.py``, ``_kernel_kind``
and ``PORT_KERNELS``). The first rule that matches decides."""

from __future__ import annotations

PORT_KERNELS = (("flash_fwd_kernel", "K1 flash_attention"),
                ("flash_bwd_dq_kernel", "K2 flash_attention_bwd_dq"),
                ("flash_bwd_dkv_kernel", "K3 flash_attention_bwd_dkv"),
                ("dkv_reduce_kernel", "K3 flash_attention_bwd_dkv"),
                ("splat_kernel", "K4 gs_splat"))

HOST_COPIES = "host-to-card copies"
FOREACH = "optimizer and EMA (foreach)"
CONV = "convolution (cuDNN)"
MATMUL = "matmul (cuBLAS)"
COPIES = "dtype casts and copies"
REDUCTIONS = "reductions (norm statistics)"
ELEMENTWISE = "other elementwise"


def kind(name: str) -> str:
    """The kind of the device kernel or copy called ``name``."""
    for sub, k in PORT_KERNELS:
        if sub in name:
            return k
    low = name.lower()
    if "memcpy htod" in low:
        return HOST_COPIES
    if "multi_tensor_apply" in low:
        return FOREACH
    if any(s in low for s in ("cudnn", "fprop", "dgrad", "conv", "winograd",
                              "nchwtonhwc", "nhwctonchw")):
        return CONV
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass")):
        return MATMUL
    if any(s in low for s in ("copy", "memcpy", "memset")):
        return COPIES
    if "reduce" in low:
        return REDUCTIONS
    return ELEMENTWISE
