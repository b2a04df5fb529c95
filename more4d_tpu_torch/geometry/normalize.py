"""Trajectory (scene-flow) normalisation and its inverses (PyTorch port of
``more4d_tpu/geometry/normalize.py``). Layout is channel-last
[B, T, H, W, 3] (xyz).

- depth-guided motion normalisation (the 4D-STraG training data):
  per-pixel deltas from the first frame divided by z0/f per axis (x, y)
  and by z0 for z, with its exact inverse;
- first-frame min/max normalisation (training) and its inverse
  ``inverse_flow_norm`` (stage 1 of inference).
"""

from __future__ import annotations

from typing import Tuple

import torch

# The dataset's factors assume a 720x960 capture at the 368x512 training
# resolution.
DATASET_H_ORI, DATASET_W_ORI = 720, 960


def _focal_factors(height: int, width: int, h_ori: int, w_ori: int
                   ) -> Tuple[float, float]:
    if w_ori / width > h_ori / height:
        fx = 1.0
        fy = w_ori / h_ori / (width / height)
    else:
        fy = 1.0
        fx = h_ori / w_ori / (height / width)
    return fx, fy


def sanitize_depth(z):
    """NaN, +-inf and 0 -> 1."""
    z = torch.nan_to_num(z, nan=1.0, posinf=1.0, neginf=1.0)
    return torch.where(z == 0, torch.ones_like(z), z)


def depth_normalization_factors(frame0, height: int, width: int,
                                h_ori: int = DATASET_H_ORI,
                                w_ori: int = DATASET_W_ORI):
    """Per-pixel (nx, ny, nz) divisors from the first frame's depth.
    frame0: [B, H, W, 3]."""
    fx, fy = _focal_factors(height, width, h_ori, w_ori)
    z0 = sanitize_depth(frame0[..., 2])
    return z0 / fx, z0 / fy, z0


def normalize_with_depth(flow, h_ori: int = DATASET_H_ORI,
                         w_ori: int = DATASET_W_ORI):
    """flow [B,T,H,W,3] absolute coords -> normalised deltas: delta = flow
    - flow[:, :1]; delta_x /= z0/fx; delta_y /= z0/fy; delta_z /= z0."""
    _, _, h, w, _ = flow.shape
    delta = flow - flow[:, :1]
    nx, ny, nz = depth_normalization_factors(flow[:, 0], h, w, h_ori, w_ori)
    return torch.stack([delta[..., 0] / nx[:, None],
                        delta[..., 1] / ny[:, None],
                        delta[..., 2] / nz[:, None]], dim=-1)


def inverse_normalize_with_depth(normalized, frame0,
                                 h_ori: int = DATASET_H_ORI,
                                 w_ori: int = DATASET_W_ORI):
    """Exact inverse of :func:`normalize_with_depth` given the first
    frame's absolute coordinates frame0 [B,H,W,3]."""
    _, _, h, w, _ = normalized.shape
    nx, ny, nz = depth_normalization_factors(frame0, h, w, h_ori, w_ori)
    delta = torch.stack([normalized[..., 0] * nx[:, None],
                         normalized[..., 1] * ny[:, None],
                         normalized[..., 2] * nz[:, None]], dim=-1)
    return delta + frame0[:, None]


def _first_frame_range(frame0):
    """The largest per-axis range of frame0 [B,H,W,3] -> [B], 1 where it
    is 0."""
    flat = frame0.reshape(frame0.shape[0], -1, 3)
    diff = (flat.amax(dim=1) - flat.amin(dim=1)).amax(dim=-1)
    return torch.where(diff == 0, torch.ones_like(diff), diff)


def first_frame_normalize(flow):
    """Min/max first-frame normalisation: x -> x/diff - frame0/diff, where
    diff is the largest per-axis range of frame 0. Returns (rel, diff)."""
    frame0 = flow[:, 0]
    diff = _first_frame_range(frame0)
    d = diff[:, None, None, None, None]
    return flow / d - frame0[:, None] / d, diff


def inverse_flow_norm(rel_flow, first_frame_coords):
    """rel_flow [B,T,H,W,3] model output; first_frame_coords [B,H,W,3]
    absolute. Returns (absolute flow [B,T,H,W,3], diff [B]) where diff is
    the largest per-axis range of the first frame (1 where that is 0)."""
    diff = _first_frame_range(first_frame_coords)
    d = diff[:, None, None, None, None]
    frame0_normalized = first_frame_coords[:, None] / d
    recovered = (rel_flow + frame0_normalized) * d
    return recovered, diff
