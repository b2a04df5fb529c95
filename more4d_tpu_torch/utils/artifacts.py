"""Artifact IO: video grid writers, video and mask readers, point-cloud
text files (a copy of ``more4d_tpu/utils/artifacts.py``, which imports no
JAX but belongs to the JAX package).

Arrays are numpy, channel-last, float in [0, 1] or uint8; a tensor is
taken through ``np.asarray`` after a move to the CPU. ``cv2`` (mp4/avi/mkv
and every reader) and ``imageio`` (gif) are imported inside the functions
that use them.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def make_grid(videos: np.ndarray, n_rows: int = 1,
              pad_value: float = 0.0) -> np.ndarray:
    """[B, T, H, W, 3] -> [T, H*rows, W*cols, 3], the samples tiled row by
    row."""
    b, t, h, w, c = videos.shape
    cols = int(np.ceil(b / n_rows))
    canvas = np.full((t, n_rows * h, cols * w, c), pad_value,
                     videos.dtype)
    for i in range(b):
        r, col = divmod(i, cols)
        canvas[:, r * h:(r + 1) * h, col * w:(col + 1) * w] = videos[i]
    return canvas


def save_videos_grid(path: str, videos, fps: int = 8,
                     n_rows: int = 1) -> None:
    """videos [B, T, H, W, 3] (or [T, H, W, 3]) float in [0, 1] or uint8 ->
    a .gif (imageio) or .mp4/.avi/.mkv (cv2) of the grid."""
    videos = _numpy(videos)
    if videos.ndim == 4:
        videos = videos[None]
    if videos.dtype != np.uint8:
        videos = (np.clip(videos, 0.0, 1.0) * 255).astype(np.uint8)
    grid = make_grid(videos, n_rows=n_rows)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".gif":
        import imageio

        imageio.mimwrite(path, grid, duration=1000.0 / fps, loop=0)
    elif ext in (".mp4", ".avi", ".mkv"):
        import cv2

        t, h, w, _ = grid.shape
        fourcc = cv2.VideoWriter_fourcc(*("mp4v" if ext == ".mp4"
                                          else "XVID"))
        vw = cv2.VideoWriter(path, fourcc, fps, (w, h))
        if not vw.isOpened():
            raise IOError(f"cv2.VideoWriter failed to open {path}")
        for frame in grid:
            vw.write(frame[:, :, ::-1])  # RGB -> BGR
        vw.release()
    else:
        raise ValueError(f"unsupported video extension: {ext}")


def read_video_frames(path: str, num_frames: Optional[int] = None,
                      size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """A video -> [T, H, W, 3] float32 in [0, 1], at most ``num_frames``
    frames, resized to ``size`` (height, width) when given."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    frames = []
    while num_frames is None or len(frames) < num_frames:
        ok, frame = cap.read()
        if not ok:
            break
        frame = frame[:, :, ::-1]  # BGR -> RGB
        if size is not None:
            frame = cv2.resize(frame, (size[1], size[0]),
                               interpolation=cv2.INTER_LINEAR)
        frames.append(frame)
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.asarray(frames, np.float32) / 255.0


def read_mask_video(path: str, num_frames: Optional[int] = None,
                    size: Optional[Tuple[int, int]] = None,
                    threshold: float = 0.5) -> np.ndarray:
    """A mask video -> [T, H, W] float32 in {0, 1} (1 = hole to inpaint)."""
    frames = read_video_frames(path, num_frames, size)
    grey = frames.mean(axis=-1)
    return (grey > threshold).astype(np.float32)


def save_pointcloud_txt(path: str, coords,
                        colors=None) -> None:
    """coords [N, 3] (and colors [N, 3] in [0, 1]) -> 'x y z [r g b]'
    rows."""
    coords = _numpy(coords)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if colors is not None:
        data = np.concatenate(
            [coords, np.clip(_numpy(colors), 0, 1) * 255.0], axis=1)
        np.savetxt(path, data, fmt="%.6f %.6f %.6f %.0f %.0f %.0f")
    else:
        np.savetxt(path, coords, fmt="%.6f")


def load_pointcloud_txt(path: str) -> Tuple[np.ndarray,
                                            Optional[np.ndarray]]:
    """The inverse of ``save_pointcloud_txt``: (coords [N, 3], colors
    [N, 3] in [0, 1] or None)."""
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    coords = data[:, :3].astype(np.float32)
    colors = None
    if data.shape[1] >= 6:
        colors = (data[:, 3:6] / 255.0).astype(np.float32)
    return coords, colors
