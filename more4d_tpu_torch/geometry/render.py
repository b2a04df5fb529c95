"""Z-buffer point-cloud rendering (PyTorch port of
``more4d_tpu/geometry/render.py``).

1. project points to normalized uv + depth;
2. keep points inside [0,1]^2 with depth >= 0;
3. per-pixel min-depth resolve (``scatter_reduce`` 'amin', the JAX
   package's ``segment_min``);
4. mean colour over the min-depth ties.

Pixel indexing is the reference's x-major buffer (idx = floor(u*W)*H +
floor(v*H), reshaped (W, H) then transposed). Frames are batched: each
frame owns its own block of segments.
"""

from __future__ import annotations

import torch

from .projection import project

BIG = 3.4e38


def zbuffer_render_video(points_video, colors, extrinsics, intrinsic,
                         height: int, width: int):
    """points_video [T,N,3]; extrinsics [T,4,4]; colors [N,C]. Returns
    (frames [T,H,W,C], holes [T,H,W] bool — True where nothing landed)."""
    t, n, _ = points_video.shape
    uv, depth = project(points_video, extrinsics, intrinsic)     # [T,N,2]
    inb = ((uv[..., 0] >= 0) & (uv[..., 0] <= 1) &
           (uv[..., 1] >= 0) & (uv[..., 1] <= 1) & (depth >= 0))
    ix = torch.clamp(torch.floor(uv[..., 0] * width), 0, width - 1)
    iy = torch.clamp(torch.floor(uv[..., 1] * height), 0, height - 1)
    idx = (ix * height + iy).to(torch.int64)
    n_seg = width * height
    idx = torch.where(inb, idx, torch.full_like(idx, n_seg))  # spare bin
    frame_off = (torch.arange(t, device=idx.device) * (n_seg + 1))[:, None]
    gidx = (idx + frame_off).reshape(-1)

    depth_masked = torch.where(inb, depth, torch.full_like(depth, BIG))
    min_depth = torch.full((t * (n_seg + 1),), BIG, dtype=depth.dtype,
                           device=depth.device)
    min_depth = min_depth.scatter_reduce(0, gidx, depth_masked.reshape(-1),
                                         "amin", include_self=True)
    keep = inb.reshape(-1) & (depth.reshape(-1) == min_depth[gidx])

    c = colors.shape[-1]
    w = keep.float()[:, None]
    cols = colors.float()[None].expand(t, n, c).reshape(-1, c)
    csum = torch.zeros((t * (n_seg + 1), c), dtype=torch.float32,
                       device=depth.device).index_add_(0, gidx, cols * w)
    cnt = torch.zeros((t * (n_seg + 1), 1), dtype=torch.float32,
                      device=depth.device).index_add_(0, gidx, w)
    csum = csum.reshape(t, n_seg + 1, c)[:, :n_seg]
    cnt = cnt.reshape(t, n_seg + 1, 1)[:, :n_seg]
    img = csum / torch.clamp(cnt, min=1.0)
    img = img.reshape(t, width, height, c).transpose(1, 2)
    hole = img.abs().sum(-1) == 0
    return img, hole


def zbuffer_render(points, colors, extrinsic, intrinsic, height: int,
                   width: int):
    """One frame: points [N,3] -> (image [H,W,C], hole_mask [H,W])."""
    img, hole = zbuffer_render_video(points[None], colors, extrinsic[None],
                                     intrinsic, height, width)
    return img[0], hole[0]


def zbuffer_render_sweep(points_video, colors, extrinsics, intrinsic,
                         height: int, width: int):
    """Camera sweep over ONE per-frame cloud: points_video [T,N,3],
    extrinsics [K*T,4,4]; output frame j renders points_video[j % T].
    Rendered one trajectory (T frames) at a time, so the K-fold tiled cloud
    is never materialised."""
    t = points_video.shape[0]
    frames, holes = [], []
    for j0 in range(0, extrinsics.shape[0], t):
        ext = extrinsics[j0:j0 + t]
        f, h = zbuffer_render_video(points_video[:ext.shape[0]], colors, ext,
                                    intrinsic, height, width)
        frames.append(f)
        holes.append(h)
    return torch.cat(frames), torch.cat(holes)
