"""Analytic FLOP count of the Wan DiT forward (a copy of
``more4d_tpu/utils/flops.py``'s ``dit_forward_flops``; the card's peak
rate is the caller's).

Counts a multiply-add as 2 FLOPs and leaves out norms, activations and
RoPE (under 1% at these shapes). Tokens L = T' * H/16 * W/16 (patch 1x2x2
on the 8x VAE grid); cross-attention keys = text_len (+ CLIP tokens for
i2v).
"""

from __future__ import annotations

from typing import Optional


def dit_forward_flops(cfg, num_tokens: int, batch: int = 1,
                      num_layers: Optional[int] = None) -> float:
    """FLOPs of one DiT forward at ``num_tokens`` tokens, times ``batch``.
    ``cfg``: a ``DiTConfig``."""
    d = cfg.dim
    f = cfg.ffn_dim
    n = num_layers if num_layers is not None else cfg.num_layers
    lt = num_tokens
    lc = cfg.text_len + (cfg.clip_tokens if cfg.model_type == "i2v" else 0)

    per_block = 0.0
    per_block += 4 * 2 * lt * d * d          # self-attn q,k,v,o projections
    per_block += 2 * 2 * lt * lt * d         # scores + PV
    per_block += 2 * 2 * lt * d * d          # cross-attn q,o
    per_block += 2 * 2 * lc * d * d          # cross-attn k,v
    per_block += 2 * 2 * lt * lc * d         # cross scores + PV
    per_block += 2 * 2 * lt * d * f          # FFN in/out
    if getattr(cfg, "motion_guidance", False):
        # MPM FiLM: two Linear(md -> 2d) over all L tokens a block
        md = cfg.motion_feature_dim
        per_block += 2 * (2 * lt * md * 2 * d)

    patch = 2 * lt * (cfg.in_dim * cfg.patch_size[0] * cfg.patch_size[1]
                      * cfg.patch_size[2]) * d
    head = 2 * lt * d * (cfg.out_dim * cfg.patch_size[0]
                         * cfg.patch_size[1] * cfg.patch_size[2])
    text_embed = 2 * cfg.text_len * cfg.text_dim * d

    return batch * (n * per_block + patch + head + text_embed)
