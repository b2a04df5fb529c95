"""Frozen counts of work and the card's peaks.

``dit_forward_flops`` is a frozen copy of the port's
``utils/flops.py``: a multiply-add is 2 FLOPs; the MPM FiLM is counted;
norms, activations and RoPE are left out (under 1% at these shapes).
The attention counts are the work the algorithm needs for one call:
each input read once and each output written once, whatever a kernel
reads again. ``cfg`` is a configuration file's dict (``configs/``).
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def num_tokens(cfg) -> int:
    """DiT tokens of the configuration's video: latent frames x the
    latent grid over the patch."""
    pt, ph, pw = cfg["patch_size"]
    frames = (cfg["num_frames"] - 1) // cfg["vae_temporal_ratio"] + 1
    h = cfg["height"] // cfg["vae_spatial_ratio"]
    w = cfg["width"] // cfg["vae_spatial_ratio"]
    return (frames // pt) * (h // ph) * (w // pw)


def dit_forward_flops(cfg, tokens: int, batch: int = 1) -> float:
    """FLOPs of one DiT forward at ``tokens`` tokens, times ``batch``."""
    d, f, n = cfg["dim"], cfg["ffn_dim"], cfg["num_layers"]
    lt = tokens
    lc = cfg["text_len"] + (cfg["clip_tokens"]
                            if cfg["model_type"] == "i2v" else 0)
    per_block = 0.0
    per_block += 4 * 2 * lt * d * d          # self-attn q,k,v,o projections
    per_block += 2 * 2 * lt * lt * d         # scores + PV
    per_block += 2 * 2 * lt * d * d          # cross-attn q,o
    per_block += 2 * 2 * lc * d * d          # cross-attn k,v
    per_block += 2 * 2 * lt * lc * d         # cross scores + PV
    per_block += 2 * 2 * lt * d * f          # FFN in/out
    if cfg.get("motion_guidance", False):
        md = cfg["motion_feature_dim"]       # two Linear(md -> 2d) a block
        per_block += 2 * (2 * lt * md * 2 * d)
    taps = math.prod(cfg["patch_size"])
    patch = 2 * lt * cfg["in_dim"] * taps * d
    head = 2 * lt * d * cfg["out_dim"] * taps
    text_embed = 2 * cfg["text_len"] * cfg["text_dim"] * d
    return batch * (n * per_block + patch + head + text_embed)


def attention_calls(cfg, batch: int):
    """The attention calls of one DiT forward, as (batch, heads, q rows,
    keys, head dim): per block the self-attention, the text and (i2v) the
    CLIP cross-attentions."""
    h = cfg["num_heads"]
    d = cfg["dim"] // h
    lt = num_tokens(cfg)
    keys = [lt, cfg["text_len"]]
    if cfg["model_type"] == "i2v":
        keys.append(cfg["clip_tokens"])
    return [(batch, h, lt, lk, d) for lk in keys] * cfg["num_layers"]


def attn_fwd_work(b, h, lq, lk, d):
    """(FLOPs, bytes) of one attention forward: q k^T and p v; q, k, v
    read and o written in bf16, the fp32 log-sum-exp written."""
    flops = 4.0 * b * h * lq * lk * d
    nbytes = 2.0 * b * d * h * (2 * lq + 2 * lk) + 4.0 * b * h * lq
    return flops, nbytes


def attn_bwd_work(b, h, lq, lk, d):
    """(FLOPs, bytes) of one attention backward: the five products a
    backward needs (s again, dp, dq, dk, dv); q, k, v, o, do read and dq,
    dk, dv written in bf16, the fp32 log-sum-exp read."""
    flops = 10.0 * b * h * lq * lk * d
    nbytes = 2.0 * b * d * h * (3 * lq + 2 * lk + lq + 2 * lk) \
        + 4.0 * b * h * lq
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the FLOPs at the
    bf16 peak and the bytes at the HBM peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
