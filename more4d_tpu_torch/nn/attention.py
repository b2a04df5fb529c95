"""Attention dispatch (PyTorch port of ``more4d_tpu/nn/attention.py``).

A CUDA tensor goes to the hand-written flash-attention kernel (K1), a CPU
tensor to its plain version; ``kernels.flash_attention.flash_attention``
makes that choice. There is no switch to a library attention call and no
sequence-parallel branch yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_lens: Optional[torch.Tensor] = None,
              name: str = "") -> torch.Tensor:
    """Scaled dot-product attention. q/k/v: [B, L, H, D] (BLHD). ``name``
    names the call for a remat policy ("sa": K1's (o, lse) are
    ``sa_o``/``sa_lse``)."""
    return flash_attention(q, k, v, kv_lens=kv_lens, name=name)
