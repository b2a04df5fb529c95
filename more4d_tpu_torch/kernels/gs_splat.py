"""Tile-based Gaussian splat rasteriser: host-side record building, the
hand-written Hopper kernel (K4) and its plain PyTorch version.

Replaces ``more4d_tpu/kernels/gs_splat.py:121 _splat_kernel`` (host prep
``_tile_records`` :45, entry ``gs_render_tiled`` :175). The kernel is
``csrc/gs_splat.cu``; what it computes and what bounds it is noted there.

Record building follows the JAX package exactly, so both composite the
same records in the same order: project the points; copy each into its
2x2 candidate 16x16 tiles; one stable sort by the packed (tile, quantised
depth) key (two stable sorts when too few bits are left for the depth);
gather the ``max_per_tile`` front-most records per tile (the dropped tail
is the farthest). Frames are batched by prefixing the key with the frame
index, which orders every frame exactly as its own sort would.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from ..geometry.projection import project

TILE = 16
DEPTH_BITS = 20


def tile_records(points, colors, extrinsics, intrinsic, height: int,
                 width: int, scale: float = 1e-4, opacity=None,
                 max_per_tile: int = 512):
    """points [F,N,3] world; colors [N,C]; extrinsics [F,4,4] cam->world;
    intrinsic normalized 3x3. Returns (u, v, sigma, opacity [F,T,K] fp32,
    colours [F,T,K,C] fp32, counts [F,T] int32, (tiles_y, tiles_x)) with
    T tiles and K = max_per_tile; records past a tile's count are padding
    (u = v = 0, sigma = 1, opacity = 0, colour 0)."""
    f, n, _ = points.shape
    dev = points.device
    tiles_x, tiles_y = width // TILE, height // TILE
    num_tiles = tiles_x * tiles_y

    uv, depth = project(points, extrinsics, intrinsic)           # [F,N,*]
    u = uv[..., 0] * width
    v = uv[..., 1] * height
    fx = intrinsic[0, 0] * width
    sigma = torch.clamp(scale * fx / torch.clamp(depth, min=1e-6), min=0.3)
    if opacity is None:
        opacity = torch.ones((n,), dtype=torch.float32, device=dev)
    opacity = opacity.float().expand(f, n)

    valid = (depth > 0) & (u > -TILE) & (u < width + TILE) & \
        (v > -TILE) & (v < height + TILE)

    # candidate 2x2 tile block around the point (footprint <= 8 px)
    tx0 = torch.floor((u - 4.0) / TILE).to(torch.int64)
    ty0 = torch.floor((v - 4.0) / TILE).to(torch.int64)
    cand = []
    for dy in (0, 1):
        for dx in (0, 1):
            tx, ty = tx0 + dx, ty0 + dy
            inb = valid & (tx >= 0) & (tx < tiles_x) & (ty >= 0) & \
                (ty < tiles_y)
            cand.append(torch.where(inb, ty * tiles_x + tx,
                                    torch.full_like(tx, num_tiles)))
    tile_ids = torch.cat(cand, dim=1)                            # [F, 4N]
    frame = torch.arange(f, device=dev, dtype=torch.int64)[:, None]
    gtile = (frame * (num_tiles + 1) + tile_ids).reshape(-1)
    depth4 = depth.repeat(1, 4)                                  # [F, 4N]

    # the JAX package packs (tile, depth) into int32: the tile field
    # takes bit_length(num_tiles) bits, the rest quantise the depth
    depth_bits = min(DEPTH_BITS, 31 - int(num_tiles).bit_length())
    if depth_bits >= 10:
        zero = torch.zeros((), dtype=depth.dtype, device=dev)
        dmax = torch.clamp(torch.where(valid, depth, zero).amax(dim=1),
                           min=1e-6)[:, None]
        top = float(2 ** depth_bits - 2)
        dq = torch.clamp(depth4 / dmax * top, 0, top).to(torch.int64)
        key = gtile * (2 ** depth_bits) + dq.reshape(-1)
        order = torch.argsort(key, stable=True)
    else:
        by_depth = torch.argsort(depth4.reshape(-1), stable=True)
        order = by_depth[torch.argsort(gtile[by_depth], stable=True)]
    sorted_tiles = gtile[order]
    # original point of each sorted record, in the flattened [F*N] cloud
    src = (order // (4 * n)) * n + order % n

    base = (frame * (num_tiles + 1)
            + torch.arange(num_tiles, device=dev)[None]).reshape(-1)
    starts = torch.searchsorted(sorted_tiles, base)
    ends = torch.searchsorted(sorted_tiles, base + 1)
    k_idx = starts[:, None] + torch.arange(max_per_tile, device=dev)[None]
    mask = k_idx < ends[:, None]                          # [F*T, K]
    k_idx = torch.clamp(k_idx, max=order.numel() - 1)
    point_idx = src[k_idx]
    counts = torch.clamp(ends - starts, max=max_per_tile).to(torch.int32)

    shape = (f, num_tiles, max_per_tile)

    def g(a, fill):
        a = a.reshape(-1).float()[point_idx]
        return torch.where(mask, a, torch.full_like(a, fill)).reshape(shape)

    rec_c = colors.float()[point_idx % n]
    rec_c = torch.where(mask[..., None], rec_c, torch.zeros_like(rec_c))
    return (g(u, 0.0), g(v, 0.0), g(sigma, 1.0), g(opacity, 0.0),
            rec_c.reshape(shape + (colors.shape[-1],)),
            counts.reshape(f, num_tiles), (tiles_y, tiles_x))


def _pixel_centres(num_tiles, tiles_x, device):
    t = torch.arange(num_tiles, device=device)[:, None]
    p = torch.arange(TILE * TILE, device=device)[None]
    px = ((t % tiles_x) * TILE + p % TILE).float() + 0.5
    py = ((t // tiles_x) * TILE + p // TILE).float() + 0.5
    return px, py                                          # [T, 256]


def _untile(out, tiles_y, tiles_x):
    """[F, T, 256, X] tile-major -> [F, H, W, X]."""
    f, x = out.shape[0], out.shape[-1]
    out = out.reshape(f, tiles_y, tiles_x, TILE, TILE, x)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(
        f, tiles_y * TILE, tiles_x * TILE, x)


def splat_plain(u, v, s, o, c, counts, tiles_x: int, background: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, one frame at a time.
    Records [F,T,K] (colours [F,T,K,C]), counts [F,T] -> (image [F,H,W,C],
    alpha [F,H,W])."""
    f, num_tiles, k = u.shape
    tiles_y = num_tiles // tiles_x
    px, py = _pixel_centres(num_tiles, tiles_x, u.device)
    live = torch.arange(k, device=u.device)[None, None] < counts[..., None]
    imgs, alphas = [], []
    for i in range(f):
        d2 = ((px[..., None] - u[i][:, None]) ** 2
              + (py[..., None] - v[i][:, None]) ** 2)      # [T, 256, K]
        ss = s[i][:, None]
        w = o[i][:, None] * torch.exp(-0.5 * d2 / (ss * ss))
        w = torch.clamp(w, max=0.9999) * live[i][:, None]
        trans = torch.cumprod(1.0 - w, dim=-1)
        trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                          dim=-1)
        contrib = w * trans
        acc = torch.einsum("tpk,tkc->tpc", contrib, c[i])
        alpha = contrib.sum(-1, keepdim=True)
        out = _untile(torch.cat([acc, alpha], -1)[None], tiles_y, tiles_x)[0]
        imgs.append(out[..., :-1] + background * (1.0 - out[..., -1:]))
        alphas.append(out[..., -1])
    return torch.stack(imgs), torch.stack(alphas)


def _kernel():
    return _build.bind(
        "gs_splat", "splat_fwd_f32",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p])


def splat_cuda(u, v, s, o, c, counts, tiles_x: int, background: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the K4 kernel over every (tile, frame). Same arguments and
    results as :func:`splat_plain`."""
    f, num_tiles, k = u.shape
    ch = c.shape[-1]
    for name, x in (("u", u), ("v", v), ("s", s), ("o", o), ("c", c)):
        if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"splat_cuda: {name} must be a contiguous fp32 "
                             f"CUDA tensor")
        if x.shape[:3] != (f, num_tiles, k):
            raise ValueError(f"splat_cuda: {name} has shape "
                             f"{tuple(x.shape)}, expected {(f, num_tiles, k)}")
    if (not counts.is_cuda or counts.dtype != torch.int32
            or counts.shape != (f, num_tiles) or not counts.is_contiguous()):
        raise ValueError("splat_cuda: counts must be a contiguous [F, T] "
                         "int32 CUDA tensor")
    if not 1 <= ch <= 4:
        raise ValueError(f"splat_cuda: {ch} colour channels (1 to 4 "
                         f"supported)")
    if num_tiles % tiles_x:
        raise ValueError("splat_cuda: tile count is not a multiple of "
                         "tiles_x")
    if k * 32 > 227 * 1024:     # two float4 a record in shared memory
        raise ValueError(f"splat_cuda: max_per_tile {k} does not fit in "
                         f"shared memory")
    h, w = (num_tiles // tiles_x) * TILE, tiles_x * TILE
    img = torch.empty((f, h, w, ch), dtype=torch.float32, device=u.device)
    alpha = torch.empty((f, h, w), dtype=torch.float32, device=u.device)
    err = _kernel()(u.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(),
                    c.data_ptr(), counts.data_ptr(), img.data_ptr(),
                    alpha.data_ptr(), f, num_tiles, tiles_x, k, h, w, ch,
                    float(background),
                    torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(err, "splat_fwd_f32")
    splat_cuda.launches += 1
    return img, alpha


splat_cuda.launches = 0


def splat(u, v, s, o, c, counts, tiles_x: int, background: float = 0.0):
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if u.is_cuda:
        return splat_cuda(u, v, s, o, c, counts, tiles_x, background)
    return splat_plain(u, v, s, o, c, counts, tiles_x, background)


def gs_render_tiled_video(points_video, colors, extrinsics, intrinsic,
                          height: int, width: int, scale: float = 1e-4,
                          opacity: Optional[torch.Tensor] = None,
                          max_per_tile: int = 512, background: float = 0.0):
    """points_video [T,N,3]; extrinsics [T,4,4]; colors [N,C] ->
    (frames [T,H,W,C], alpha [T,H,W]). H and W must be multiples of 16."""
    if height % TILE or width % TILE:
        raise ValueError(f"gs_render_tiled needs H and W to be multiples "
                         f"of {TILE}, got {height}x{width}")
    u, v, s, o, c, counts, (_, tx) = tile_records(
        points_video, colors, extrinsics, intrinsic, height, width, scale,
        opacity, max_per_tile)
    return splat(u, v, s, o, c, counts, tx, background)


def gs_render_tiled(points, colors, extrinsic, intrinsic, height: int,
                    width: int, **kw):
    """points [N,3] world; colors [N,C]; extrinsic cam->world 4x4;
    intrinsic normalized 3x3 -> (image [H,W,C], alpha [H,W])."""
    img, alpha = gs_render_tiled_video(points[None], colors, extrinsic[None],
                                       intrinsic, height, width, **kw)
    return img[0], alpha[0]


def gs_render_sweep(points_video, colors, extrinsics, intrinsic,
                    height: int, width: int, **kw):
    """Camera sweep over ONE per-frame cloud: points_video [T,N,3],
    extrinsics [K*T,4,4]; output frame j renders points_video[j % T].
    One trajectory (T frames) per kernel launch, so the K-fold tiled cloud
    and its records are never all live at once."""
    t = points_video.shape[0]
    frames, alphas = [], []
    for j0 in range(0, extrinsics.shape[0], t):
        ext = extrinsics[j0:j0 + t]
        f, a = gs_render_tiled_video(points_video[:ext.shape[0]], colors,
                                     ext, intrinsic, height, width, **kw)
        frames.append(f)
        alphas.append(a)
    return torch.cat(frames), torch.cat(alphas)
