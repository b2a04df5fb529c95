"""ViSM training pairs (PyTorch port of ``more4d_tpu/data/vism.py``).

The reference's ViSMDataset path:

- ``project_point_cloud``: a frame's point cloud projected with normalised
  intrinsics (cx = cy = 0.5, fx/fy from the source/target aspect), resolved
  by a z-buffer: the least depth a pixel wins, its colour the mean over the
  points at that depth; pixels are indexed column-major (x*H + y) and the
  flat image goes through the reference's reshape(W, H).T. Written as the
  reference writes it, with scatter ops (``scatter_reduce_`` 'amin', then
  ``index_add_`` of the colours and the counts in float64), on the device
  of the points it is given. The JAX package's compiled z-buffer has no
  counterpart: one scatter pass over 188,416 points takes milliseconds.
- the pre-rendered pair ``*_dt3d_render.mp4`` + ``*_mask_render.mp4``, the
  mask binary (any channel lit);
- frame sampling with stride 2 beyond the frame budget, last-frame padding;
- the inpaint sample: ``mask_pixel_values = projected*(1-mask) - mask``,
  the first frame as the CLIP image, the text dropout, and the t2v flag: a
  sample whose mask is all holes keeps its inpaint conditioning zeroed with
  p=0.9 (applied by the trainer through ``t2v_keep_flag``).

Both dropouts are drawn from a numpy ``RandomState`` in the JAX package's
order, so a seed gives its samples.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device


def vism_intrinsics(h: int, w: int, h_ori: float = 540.0,
                    w_ori: float = 960.0, device="cpu") -> torch.Tensor:
    """Normalised pinhole intrinsics [3, 3] float32: fx/fy chosen so the
    source aspect (540x960 in the reference) maps into the target frame;
    fx = 1 where the width is the tighter fit, as at 368x512, which gives
    (fx, fy) = (1, 1.2784)."""
    if w_ori / w > h_ori / h:
        fx = 1.0
        fy = (w_ori / h_ori) / (w / h)
    else:
        fy = 1.0
        fx = (h_ori / w_ori) / (h / w)
    return torch.tensor([[fx, 0, 0.5], [0, fy, 0.5], [0, 0, 1]],
                        dtype=torch.float32, device=device)


def project_point_cloud(coords: torch.Tensor, colors: torch.Tensor, h: int,
                        w: int, intrinsic=None, extrinsic=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """coords [N, 3] camera-space, colors [N, 3] -> (color image [H, W, 3],
    hole mask [H, W, 3] with 1 = hole), float32 on coords' device."""
    dev = coords.device
    intrinsic = (vism_intrinsics(h, w, device=dev) if intrinsic is None
                 else torch.as_tensor(intrinsic, dtype=torch.float32,
                                      device=dev))
    pts = coords.float()
    if extrinsic is not None:
        e = torch.as_tensor(extrinsic, dtype=torch.float32, device=dev)
        pts = pts @ e[:3, :3].T + e[:3, 3]
    depth = pts[:, 2]
    uv = pts[:, :2] / depth.clamp_min(1e-12)[:, None]
    u = intrinsic[0, 0] * uv[:, 0] + intrinsic[0, 2]
    v = intrinsic[1, 1] * uv[:, 1] + intrinsic[1, 2]

    mask = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (depth >= 0)
    if not bool(mask.any()):
        return (torch.zeros((h, w, 3), device=dev),
                torch.ones((h, w, 3), device=dev))

    cp = colors.to(dev)[mask].double()
    dp = depth[mask]
    # column-major flat index: floor(u*W) * H + floor(v*H)
    ix = torch.floor(u[mask] * w).clamp(0, w - 1)
    iy = torch.floor(v[mask] * h).clamp(0, h - 1)
    idx = (ix * h + iy).long()

    # the least depth a pixel (index_reduce_ 'amin')
    min_depth = torch.full((h * w,), float(dp.max()), dtype=dp.dtype,
                           device=dev)
    min_depth.scatter_reduce_(0, idx, dp, "amin", include_self=False)
    keep = dp == min_depth[idx]

    # the mean colour over the points at that depth (scatter 'mean')
    kept = idx[keep]
    flat = torch.zeros((h * w, 3), dtype=torch.float64, device=dev)
    flat.index_add_(0, kept, cp[keep])
    count = torch.zeros(h * w, dtype=torch.float64, device=dev)
    count.index_add_(0, kept, torch.ones_like(kept, dtype=torch.float64))
    flat = torch.where(count[:, None] > 0,
                       flat / count.clamp_min(1.0)[:, None], flat)

    # the reference's reshape(W, H, 3).transpose(0, 1)
    color = flat.reshape(w, h, 3).transpose(0, 1).float().contiguous()
    hole = (color.sum(-1) == 0).float()
    return color, hole[..., None].repeat(1, 1, 3)


def sample_frame_indices(n_available: int, max_num_frames: int):
    """Stride-2 sampling beyond the budget, else every frame. Indices past
    the clip repeat its last frame (for max < n < 2*max the stride-2 range
    runs past the end, which the reference's video reader tolerates)."""
    if n_available > max_num_frames:
        idx = list(range(0, max_num_frames * 2, 2))[:max_num_frames]
        return [min(i, n_available - 1) for i in idx]
    return list(range(n_available))


def pad_frames(frames, max_num_frames: int):
    """Last-frame padding to the budget, of a numpy array or a tensor."""
    n = frames.shape[0]
    if n >= max_num_frames:
        return frames[:max_num_frames]
    if isinstance(frames, np.ndarray):
        pad = np.repeat(frames[-1:], max_num_frames - n, axis=0)
        return np.concatenate([frames, pad], axis=0)
    pad = frames[-1:].expand(max_num_frames - n, *frames.shape[1:])
    return torch.cat([frames, pad], dim=0)


@dataclasses.dataclass
class ViSMSample:
    pixel_values: torch.Tensor        # [T,H,W,3] original video in [-1,1]
    projected_images: torch.Tensor    # [T,H,W,3] rendered/projected, [-1,1]
    mask: torch.Tensor                # [T,H,W,3] 1 = hole
    mask_pixel_values: torch.Tensor   # [T,H,W,3] projected*(1-m) - m
    clip_image01: torch.Tensor        # [H,W,3] first original frame, [0,1]
    text: str
    t2v_keep_flag: float              # 0 -> zero the inpaint conditioning


def prepare_vism_sample(video01, text: str, coords=None, colors=None,
                        prerendered=None, prerendered_mask=None,
                        max_num_frames: int = 49, text_dropout: float = 0.1,
                        t2v_dropout: float = 0.9,
                        rng: Optional[np.random.RandomState] = None,
                        device="cuda") -> ViSMSample:
    """One inpaint training pair, its tensors float32 on ``device``.

    video01: [T,H,W,3] original frames in [0,1]. Either coords [T,N,3] and
    colors [N,3] in [0,1] (the live projection), or prerendered [T,H,W,3]
    in [0,1] and prerendered_mask [T,H,W] or [T,H,W,3] (the 3DGS path,
    ``--use_3dgs``); numpy arrays or tensors."""
    dev = resolve_device(device)
    rng = rng or np.random.RandomState()

    def put(a):
        return torch.as_tensor(a).to(dev, torch.float32)

    video01 = put(video01)
    _, h, w, _ = video01.shape

    if prerendered is not None:
        proj = pad_frames(put(prerendered), max_num_frames)
        m = put(prerendered_mask)
        if m.dim() == 3:
            m = m[..., None].repeat(1, 1, 1, 3)
        # binary: any channel lit
        m = (m.sum(-1, keepdim=True) > 0).float().repeat(1, 1, 1, 3)
        mask = pad_frames(m, max_num_frames)
    else:
        if coords is None or colors is None:
            raise ValueError("prepare_vism_sample: give coords and colors, "
                             "or prerendered and prerendered_mask")
        coords, colors = put(coords), put(colors)
        frames, masks = [], []
        for i in range(min(coords.shape[0], max_num_frames)):
            color, hole = project_point_cloud(coords[i], colors, h, w)
            frames.append(color)
            masks.append(hole)
        proj = pad_frames(torch.stack(frames), max_num_frames)
        mask = pad_frames(torch.stack(masks), max_num_frames)

    video = pad_frames(video01, max_num_frames) * 2.0 - 1.0
    proj = proj * 2.0 - 1.0
    mask_px = proj * (1.0 - mask) - mask

    if rng.rand() < text_dropout:
        text = ""
    # the t2v flag: all-hole samples keep their conditioning zeroed 90% of
    # the time (the draw is made only for them, as in the JAX package)
    all_hole = bool((mask >= 1.0 - 1e-6).all())
    keep = 0.0 if (all_hole and rng.rand() < t2v_dropout) else 1.0

    return ViSMSample(
        pixel_values=video, projected_images=proj, mask=mask,
        mask_pixel_values=mask_px, clip_image01=video[0] * 0.5 + 0.5,
        text=text, t2v_keep_flag=keep)


def load_prerendered(video_path: str, max_num_frames: int = 49,
                     size: Optional[Tuple[int, int]] = None):
    """The pre-rendered pair ``*_dt3d_render.mp4`` / ``*_mask_render.mp4``
    of a clip (the reference's path convention), numpy [T,H,W,3] in [0,1]
    each, sampled as ``sample_frame_indices`` picks."""
    from ..utils.artifacts import read_video_frames

    render_path = video_path.replace("videos", "dt3d_render").replace(
        ".mp4", "_dt3d_render.mp4")
    mask_path = video_path.replace("videos", "dt3d_render").replace(
        ".mp4", "_mask_render.mp4")
    render = read_video_frames(render_path, size=size)
    idx = sample_frame_indices(render.shape[0], max_num_frames)
    render = render[idx]
    mask = read_video_frames(mask_path, size=size)[idx]
    return render, mask
