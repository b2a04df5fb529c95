"""CameraCtrl-style Plücker-ray camera conditioning, host-side numpy (the
port's copy of ``more4d_tpu/data/camera_cond.py``): pose rows -> Plücker
maps, and the temporal 4x fold of the camera video into latent-frame
channels. The folded maps are the DiT's ``y_camera``, read by its control
adapter (``models/wan_dit.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class Camera:
    """RealEstate10K-style pose row: [ts, fx, fy, cx, cy, 0, 0, w2c(3x4)]."""

    def __init__(self, entry: Sequence[float]):
        fx, fy, cx, cy = entry[1:5]
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        w2c = np.eye(4)
        w2c[:3, :] = np.asarray(entry[7:]).reshape(3, 4)
        self.w2c_mat = w2c
        self.c2w_mat = np.linalg.inv(w2c)


def get_relative_pose(cams: List[Camera]) -> np.ndarray:
    """Poses relative to the first camera."""
    abs2rel = np.eye(4) @ cams[0].w2c_mat
    out = [np.eye(4)] + [abs2rel @ c.c2w_mat for c in cams[1:]]
    return np.asarray(out, np.float32)


def ray_condition(K: np.ndarray, c2w: np.ndarray, height: int,
                  width: int) -> np.ndarray:
    """Plücker embedding [F, H, W, 6].

    K: [F, 4] pixel intrinsics (fx, fy, cx, cy); c2w: [F, 4, 4]."""
    f = K.shape[0]
    j, i = np.meshgrid(np.arange(height, dtype=np.float64),
                       np.arange(width, dtype=np.float64), indexing="ij")
    i = i.reshape(1, -1) + 0.5
    j = j.reshape(1, -1) + 0.5

    fx, fy, cx, cy = [K[:, k:k + 1] for k in range(4)]
    zs = np.ones_like(i) * np.ones((f, 1))
    xs = (i - cx) / fx * zs
    ys = (j - cy) / fy * zs
    directions = np.stack([xs, ys, zs], -1)
    directions = directions / np.linalg.norm(directions, axis=-1,
                                             keepdims=True)

    rays_d = directions @ np.transpose(c2w[:, :3, :3], (0, 2, 1))
    rays_o = np.broadcast_to(c2w[:, None, :3, 3], rays_d.shape)
    rays_dxo = np.cross(rays_o, rays_d)
    plucker = np.concatenate([rays_dxo, rays_d], axis=-1)
    return plucker.reshape(f, height, width, 6).astype(np.float32)


def process_pose_params(cam_params: Sequence[Sequence[float]],
                        width: int = 672, height: int = 384,
                        original_pose_width: int = 1280,
                        original_pose_height: int = 720) -> np.ndarray:
    """Pose rows -> Plücker video [F, H, W, 6]."""
    cams = [Camera(p) for p in cam_params]
    sample_ratio = width / height
    pose_ratio = original_pose_width / original_pose_height
    if pose_ratio > sample_ratio:
        resized_w = height * pose_ratio
        for c in cams:
            c.fx = resized_w * c.fx / width
    else:
        resized_h = width / pose_ratio
        for c in cams:
            c.fy = resized_h * c.fy / height
    K = np.asarray([[c.fx * width, c.fy * height, c.cx * width,
                     c.cy * height] for c in cams], np.float32)
    c2ws = get_relative_pose(cams)
    return ray_condition(K, c2ws, height, width)


def fold_camera_video(plucker: np.ndarray) -> np.ndarray:
    """[F, H, W, 6] with F = 1+4k -> [F', H, W, 24]: first frame repeated 4x,
    groups of 4 frames folded into channels."""
    f, h, w, c = plucker.shape
    x = np.concatenate([np.repeat(plucker[:1], 4, axis=0), plucker[1:]],
                       axis=0)
    fl = x.shape[0] // 4
    x = x.reshape(fl, 4, h, w, c)
    return np.moveaxis(x, 1, 3).reshape(fl, h, w, 4 * c)
