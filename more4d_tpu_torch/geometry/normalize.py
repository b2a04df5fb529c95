"""Inverse trajectory (scene-flow) normalization used by stage 1
(PyTorch port of ``more4d_tpu/geometry/normalize.py:inverse_flow_norm``).
Layout is channel-last [B, T, H, W, 3] (xyz)."""

from __future__ import annotations

import torch


def inverse_flow_norm(rel_flow, first_frame_coords):
    """rel_flow [B,T,H,W,3] model output; first_frame_coords [B,H,W,3]
    absolute. Returns (absolute flow [B,T,H,W,3], diff [B]) where diff is
    the largest per-axis range of the first frame (1 where that is 0)."""
    b = rel_flow.shape[0]
    flat = first_frame_coords.reshape(b, -1, 3)
    diff = (flat.amax(dim=1) - flat.amin(dim=1)).amax(dim=-1)
    diff = torch.where(diff == 0, torch.ones_like(diff), diff)
    d = diff[:, None, None, None, None]
    frame0_normalized = first_frame_coords[:, None] / d
    recovered = (rel_flow + frame0_normalized) * d
    return recovered, diff
