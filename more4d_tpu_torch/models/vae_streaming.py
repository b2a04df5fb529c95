"""Chunked streaming drivers for the causal VAE (PyTorch port of
``more4d_tpu/models/vae_streaming.py``): encode in input-frame chunks
[1, 4, 4, ...], decode one latent frame at a time, carrying the conv caches
from chunk to chunk, so peak memory does not grow with T.

The JAX package's ``static_hint`` skips chunks of a repeated-frame video
once the caches reach a fixed point; the skip is exact (it triggers only on
bitwise convergence), so the port computes every chunk instead, which
changes no number.
"""

from __future__ import annotations

import torch

from .wan_vae import WanVAE


def _block(n: int, per_step: int) -> int:
    """The largest block size <= per_step that divides n."""
    g = max(1, min(per_step, n))
    while n % g:
        g -= 1
    return g


def encode_streamed(model: WanVAE, x, normalize: bool = True,
                    static_hint: bool = False, latents_per_step: int = 1):
    """x: [B, T, H, W, 3] with T = 1 + 4k -> (mu, logvar). Any
    ``latents_per_step`` gives the same numbers; ``static_hint`` is accepted
    for the JAX signature and changes nothing (see the module note)."""
    t = x.shape[1]
    if (t - 1) % 4:
        raise ValueError(f"T must be 1+4k, got {t}")
    (mu, lv), cache = model.encode(x[:, :1], normalize=normalize,
                                   return_cache=True)
    mus, lvs = [mu], [lv]
    step = 4 * _block((t - 1) // 4, latents_per_step)
    for s in range(1, t, step):
        (mu, lv), cache = model.encode(x[:, s:s + step], normalize=normalize,
                                       cache=cache, return_cache=True)
        mus.append(mu)
        lvs.append(lv)
    return torch.cat(mus, dim=1), torch.cat(lvs, dim=1)


def decode_streamed(model: WanVAE, z, normalize: bool = True,
                    latents_per_step: int = 1):
    """z: [B, T', h', w', z_dim] -> [B, 1 + 4*(T'-1), H, W, 3]."""
    t = z.shape[1]
    x, cache = model.decode(z[:, :1], normalize=normalize, return_cache=True)
    xs = [x]
    step = _block(t - 1, latents_per_step) if t > 1 else 1
    for s in range(1, t, step):
        x, cache = model.decode(z[:, s:s + step], normalize=normalize,
                                cache=cache, return_cache=True)
        xs.append(x)
    return torch.cat(xs, dim=1)
