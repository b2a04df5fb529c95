"""Scene-flow (dense point-trajectory) sample loading and preparation
(PyTorch port of ``more4d_tpu/data/sceneflow.py``; host-side numpy with the
port's own normalisation).

``*_dt3d_pred.pkl`` files hold ``coords [T, H*W, 3]`` (per-pixel 3D world
coordinates over time) and ``colors [H*W, 3]`` of the first frame.
Preparation:

- reshape to [T, H, W, 3];
- depth-guided motion normalisation (the 4D-STraG default) or first-frame
  min/max normalisation, with the large-depth filter;
- frame limit or pad to ``max_num_frames`` (49);
- control video = the first RGB frame repeated T times;
- text dropout is the trainer's (``StraagTrainer.prepare_batch``).
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from ..geometry.normalize import first_frame_normalize, normalize_with_depth


@dataclasses.dataclass
class SceneFlowSample:
    flow: np.ndarray            # [T, H, W, 3] normalised trajectory target
    first_frame_coords: np.ndarray   # [H, W, 3] absolute
    control_video: np.ndarray   # [T, H, W, 3] repeated first frame, [-1, 1]
    first_frame_rgb: np.ndarray  # [H, W, 3] in [0, 1] (MPM input)
    depth_image: np.ndarray     # [1, H, W, 3] depth in [-1, 1]


def load_sceneflow_pickle(path: str, height: int, width: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (coords [T, H, W, 3], colors [H, W, 3] in [0, 255])."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    coords = np.asarray(data["coords"], np.float32)
    colors = np.asarray(data["colors"], np.float32)
    if coords.ndim == 3:
        coords = coords.reshape(coords.shape[0], height, width, 3)
    if colors.ndim == 2:
        colors = colors.reshape(height, width, 3)
    return coords, colors


def depth_to_image(depth: np.ndarray) -> np.ndarray:
    """Depth map [H, W] -> 3ch image in [-1, 1] by per-image min-max: clamp
    to [0, 1e4], non-finite or near-zero values to 1, then
    2*(d-min)/(max-min+1e-8)-1."""
    d = np.clip(depth, 0.0, 10000.0)
    d[~np.isfinite(d) | (d < 1e-5)] = 1.0
    dmin, dmax = d.min(), d.max()
    d = 2.0 * (d - dmin) / (dmax - dmin + 1e-8) - 1.0
    return np.repeat(d[..., None], 3, axis=-1).astype(np.float32)


def prepare_straag_sample(coords: np.ndarray, colors: np.ndarray,
                          max_num_frames: int = 49,
                          normalize: str = "depth",
                          skip_large_depth: bool = True,
                          large_depth_threshold: float = 500.0
                          ) -> Optional[SceneFlowSample]:
    """coords [T, H, W, 3]; colors [H, W, 3] in [0, 255]. Returns None when
    the sample fails the large-depth filter."""
    if skip_large_depth:
        frame0 = coords[0].reshape(-1, 3)
        rng0 = frame0.max(0) - frame0.min(0)
        if normalize == "minmax" and rng0.max() > large_depth_threshold:
            return None
        if normalize != "minmax" and np.abs(coords).max() \
                > large_depth_threshold:
            return None

    c = torch.from_numpy(np.ascontiguousarray(coords, np.float32))[None]
    if normalize == "depth":
        flow = normalize_with_depth(c)[0].numpy()
    elif normalize == "minmax":
        flow = first_frame_normalize(c)[0][0].numpy()
    elif normalize == "track_z":
        flow = coords - coords[:1]
    else:
        raise ValueError(normalize)

    # limit or pad the frames to 1 + 4k
    if flow.shape[0] > max_num_frames:
        flow = flow[:max_num_frames]
    elif flow.shape[0] < max_num_frames:
        pad = np.repeat(flow[-1:], max_num_frames - flow.shape[0], axis=0)
        flow = np.concatenate([flow, pad], axis=0)

    rgb01 = colors / 255.0
    control = np.repeat((rgb01 * 2 - 1)[None], max_num_frames, axis=0)
    depth_img = depth_to_image(coords[0, ..., 2])[None]

    return SceneFlowSample(
        flow=flow.astype(np.float32),
        first_frame_coords=coords[0],
        control_video=control.astype(np.float32),
        first_frame_rgb=rgb01.astype(np.float32),
        depth_image=depth_img,
    )
