"""Linear resize with ``jax.image.resize`` semantics.

``torch.nn.functional.interpolate`` does not antialias when it
downsamples; ``jax.image.resize(..., "bilinear"/"trilinear")`` does (its
``antialias=True`` default widens the triangle kernel by the inverse scale).
The two differ by up to 0.77 on the stage-2 mask resize (368x512 -> 46x64),
so the port resizes the JAX way: one separable weight matrix per axis whose
size changes, built as ``jax._src.image.scale.compute_weight_mat`` builds it
(sample at (i + 0.5) / scale - 0.5, triangle kernel widened by
max(1/scale, 1), columns normalised to sum 1, samples outside the input
zeroed), contracted with the input in its dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch

_EPS_SUM = 1000.0 * float(torch.finfo(torch.float32).eps)


def _weight_mat(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] float32 interpolation weights for one axis."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
                * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32,
                                          device=device)[:, None]).abs()
    weights = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > _EPS_SUM,
                          weights / torch.where(total != 0, total, 1.0),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Linear (bi/trilinear) resize of every axis whose size differs, as
    ``jax.image.resize(x, shape, "linear")`` with its default antialias."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match rank of "
                         f"{tuple(x.shape)}")
    if not x.is_floating_point():
        x = x.float()
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = _weight_mat(n_in, n_out, x.device).to(x.dtype)
        x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x
