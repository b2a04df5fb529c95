"""Attention dispatch (PyTorch port of ``more4d_tpu/nn/attention.py``).

A CUDA tensor goes to the hand-written flash-attention kernel (K1), a CPU
tensor to its plain version; ``kernels.flash_attention.flash_attention``
makes that choice. There is no switch to a library attention call. With
``sequence_parallel`` and a mesh whose ``seq`` axis is larger than one
installed (``parallel.set_mesh``), the call goes through Ulysses'
all-to-alls (``parallel/ulysses.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_lens: Optional[torch.Tensor] = None,
              name: str = "", sequence_parallel: bool = False
              ) -> torch.Tensor:
    """Scaled dot-product attention. q/k/v: [B, L, H, D] (BLHD). ``name``
    names the call for a remat policy ("sa": K1's (o, lse) are
    ``sa_o``/``sa_lse``). With ``sequence_parallel`` q/k/v hold this
    rank's L/S tokens when a seq mesh is installed."""
    def fn(q, k, v, lens):
        return flash_attention(q, k, v, kv_lens=lens, name=name)

    if sequence_parallel:
        from ..parallel.ulysses import seq_parallel_size, ulysses_attention

        if seq_parallel_size() > 1:
            return ulysses_attention(fn, q, k, v, kv_lens)
    return fn(q, k, v, kv_lens)
