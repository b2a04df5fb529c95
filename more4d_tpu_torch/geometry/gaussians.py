"""Differentiable point-splat rendering (PyTorch port of
``more4d_tpu/geometry/gaussians.py``).

MoRe4D renders isotropic, fixed-scale point splats only (scale 1e-4 world
units, identity rotation, opacity 1, no SH): each covers a few pixels.
Every point is splatted into a static KxK pixel footprint with its
projected 2D gaussian weight, and occlusion is a soft z-test against the
per-pixel minimum depth (temperature ``tau``):

    w_i(p) = G(||p - u_i||; sigma_i) * exp(-(z_i - z_min(p)) / tau)
    color(p) = sum w_i c_i / sum w_i

As tau -> 0 this is the z-buffer render. It is differentiable through
autograd with respect to the points and colours: the per-pixel minimum is
a ``scatter_reduce`` 'amin' (its gradient shared among ties, as JAX's
``segment_min`` shares it), the sums ``index_add``.
"""

from __future__ import annotations

import torch

from .projection import project

BIG = 3.4e38


def gs_render(points, colors, extrinsic, intrinsic, height: int, width: int,
              scale: float = 1e-4, opacity=None, tau: float = 1e-3,
              footprint: int = 3, background: float = 0.0):
    """points [N, 3] world; colors [N, C] in [0, 1]; extrinsic cam->world
    4x4; intrinsic normalised 3x3. Returns (image [H, W, C], alpha [H, W]),
    float32."""
    n = points.shape[0]
    dev = points.device
    uv, depth = project(points, extrinsic, intrinsic)
    u_pix = uv[:, 0] * width
    v_pix = uv[:, 1] * height

    # projected gaussian std in pixels; 0.3 px low-pass like the reference
    # rasteriser's dilation
    fx = intrinsic[0, 0] * width
    sigma = torch.clamp_min(scale * fx / torch.clamp_min(depth, 1e-6), 0.3)

    valid = (depth > 0) & (u_pix >= -footprint) & \
        (u_pix < width + footprint) & (v_pix >= -footprint) & \
        (v_pix < height + footprint)
    if opacity is None:
        opacity = torch.ones((n,), dtype=torch.float32, device=dev)

    n_seg = height * width
    ci = torch.clamp(torch.floor(u_pix), 0, width - 1).long()
    cj = torch.clamp(torch.floor(v_pix), 0, height - 1).long()

    r = footprint // 2
    offsets = [(di, dj) for di in range(-r, r + 1)
               for dj in range(-r, r + 1)]

    # pass 1: per-pixel min depth over all contributing splat positions
    big = torch.full((), BIG, dtype=depth.dtype, device=dev)
    min_depth = torch.full((n_seg + 1,), BIG, dtype=depth.dtype, device=dev)
    idx_all, w_all = [], []
    for di, dj in offsets:
        px = ci + di
        py = cj + dj
        inb = valid & (px >= 0) & (px < width) & (py >= 0) & (py < height)
        idx = torch.where(inb, py * width + px, n_seg)
        d2 = (px + 0.5 - u_pix) ** 2 + (py + 0.5 - v_pix) ** 2
        g = torch.exp(-0.5 * d2 / sigma ** 2) * opacity
        g = torch.where(inb, g, torch.zeros_like(g))
        idx_all.append(idx)
        w_all.append(g)
        # only splats with meaningful mass may claim the pixel's z-test;
        # otherwise sub-percent gaussian bleed would occlude whole pixels
        dmask = torch.where(inb & (g > 0.05), depth, big)
        seg = torch.full((n_seg + 1,), float("inf"), dtype=depth.dtype,
                         device=dev).scatter_reduce(0, idx, dmask, "amin",
                                                    include_self=True)
        min_depth = torch.minimum(min_depth, seg)

    # pass 2: soft-occlusion weighted accumulation
    cf = colors.float()
    csum = torch.zeros((n_seg + 1, cf.shape[-1]), dtype=torch.float32,
                       device=dev)
    wsum = torch.zeros((n_seg + 1,), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=depth.dtype, device=dev)
    for idx, g in zip(idx_all, w_all):
        occ = torch.exp(-torch.maximum(depth - min_depth[idx], zero) / tau)
        w = g * occ
        csum = csum.index_add(0, idx, w[:, None] * cf)
        wsum = wsum.index_add(0, idx, w)

    img = csum[:n_seg] / torch.clamp_min(wsum[:n_seg, None], 1e-8)
    # coverage proxy: saturates quickly once any splat mass lands
    alpha = 1.0 - torch.exp(-3.0 * wsum[:n_seg])
    img = torch.where(wsum[:n_seg, None] > 1e-6, img,
                      torch.full_like(img, background))
    return img.reshape(height, width, -1), alpha.reshape(height, width)


def gs_render_video(points_video, colors, extrinsics, intrinsic, height,
                    width, scale: float = 1e-4, **kw):
    """points_video [T, N, 3]; extrinsics [T, 4, 4] -> (frames [T, H, W,
    C], alpha [T, H, W]): ``gs_render`` a frame."""
    frames = [gs_render(pts, colors, ext, intrinsic, height, width,
                        scale=scale, **kw)
              for pts, ext in zip(points_video, extrinsics)]
    return (torch.stack([f[0] for f in frames]),
            torch.stack([f[1] for f in frames]))
