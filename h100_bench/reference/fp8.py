"""float8_e4m3fn rounding in plain arithmetic.

e4m3fn: 3 mantissa bits, exponent bias 7, normals from 2^-6, subnormals
in steps of 2^-9, largest finite 448, no infinity. A value rounds to the
nearest representable one, ties to even; beyond 448 it saturates to
448 (the cast the configuration states saturates).
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
_MIN_EXP = -6            # smallest normal exponent
_MANT = 3


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to the nearest e4m3fn value, in fp32."""
    x = x.float()
    a = x.abs()
    _, e = torch.frexp(a)                    # a = m 2^e, m in [0.5, 1)
    # the spacing of e4m3 values around a: 2^(exponent - 3), at least the
    # subnormals' 2^-9
    exp = torch.clamp(e - 1, min=_MIN_EXP)
    quantum_exp = exp - _MANT
    q = torch.ldexp(torch.round(torch.ldexp(a, -quantum_exp)),
                    quantum_exp.float())
    q = torch.clamp(q, max=E4M3_MAX)
    return torch.copysign(q, x)


def scaled_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` computed in fp8 with one scale a tensor: x / s rounded to
    e4m3 and multiplied back, s = max|x| / 448."""
    s = (x.detach().abs().amax().float() / E4M3_MAX).clamp_min(1e-30)
    return round_e4m3(x / s) * s


def stored_in_fp8(name: str) -> bool:
    """Whether the 14B configuration stores the DiT tensor ``name`` (the
    released checkpoint's name) in fp8: outside the blocks every matrix
    and convolution kernel but the patch embedding's; inside the blocks
    every tensor but the norms and the modulation table."""
    if name.startswith("blocks."):
        rest = name.split(".", 2)[2]
        return not (rest == "modulation" or "norm" in rest)
    module, leaf = name.rsplit(".", 1)
    if leaf != "weight" or module == "patch_embedding":
        return False
    return module not in ("img_emb.proj.0", "img_emb.proj.4")
