"""Scene-flow samples for the VAE trajectory adaptors (PyTorch port of
``more4d_tpu/data/vae_flow.py``; host-side numpy).

Scene-flow pickles listed one video path a line (``videos`` ->
``dt3d<posfix>``, ``.mp4`` -> ``_dt3d_pred.pkl``), each giving:

- ``coords``            [T, H, W, 3] absolute per-pixel 3D trajectories;
- ``coords_delta``      coords - coords[0:1];
- ``coords_normalized`` coords[:max_frames] / abs(coords[:max_frames]).max();
- ``colors``            [H, W, 3];
- ``vis``               [T, H, W] visibility, where the pickle has it.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import List, Optional

import numpy as np
import torch


def sceneflow_paths_from_list(list_path: str, posfix: str = "",
                              data_root: Optional[str] = None) -> List[str]:
    """One video path a line -> the scene-flow pickle paths (relative ones
    under ``data_root``, by default the list's directory)."""
    base = data_root or os.path.dirname(os.path.abspath(list_path))
    out = []
    with open(list_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            p = line.replace("videos", "dt3d" + posfix).replace(
                ".mp4", "_dt3d_pred.pkl")
            out.append(p if os.path.isabs(p) else os.path.join(base, p))
    return out


@dataclasses.dataclass
class VAEFlowSample:
    coords: np.ndarray             # [T, H, W, 3]
    coords_delta: np.ndarray       # [T, H, W, 3]
    coords_normalized: np.ndarray  # [Tm, H, W, 3]
    colors: np.ndarray             # [H, W, 3]
    vis: Optional[np.ndarray]      # [T, H, W] or None


def load_vae_flow_sample(pkl_path: str, height: int = 384,
                         width: int = 512,
                         max_frames: int = 17) -> VAEFlowSample:
    with open(pkl_path, "rb") as f:
        data = pickle.load(f)
    coords = np.asarray(data["coords"], np.float32)
    if coords.ndim == 4 and coords.shape[0] == 1:
        coords = coords[0]
    t = coords.shape[0]
    coords = coords.reshape(t, height, width, 3)
    colors = np.asarray(data["colors"], np.float32)
    if colors.ndim == 3 and colors.shape[0] == 1:
        colors = colors[0]
    colors = colors.reshape(height, width, 3)
    delta = coords - coords[0:1]
    cm = coords[:max_frames]
    normalized = cm / max(np.abs(cm).max(), 1e-12)
    vis = None
    if "vis" in data:
        vis = np.asarray(data["vis"], np.float32).reshape(-1, height, width)
    return VAEFlowSample(coords=coords, coords_delta=delta.astype(np.float32),
                         coords_normalized=normalized.astype(np.float32),
                         colors=colors, vis=vis)


def normalize_vae_target(sample: VAEFlowSample, mode: str,
                         num_frames: int = 17, h_ori: int = 720,
                         w_ori: int = 960) -> np.ndarray:
    """The four normalisations of the VAE trainer -> [T, H, W, 3]:
    'track' (global abs-max), 'track_first_frame' (delta over the first
    frame's largest extent), 'track_z' (depth-guided), 'delta'."""
    if mode == "track":
        return sample.coords_normalized[:num_frames]
    if mode == "track_first_frame":
        frame0 = sample.coords[0].reshape(-1, 3)
        diff = float((frame0.max(0) - frame0.min(0)).max())
        diff = diff if diff != 0 else 1.0
        return (sample.coords_delta[:num_frames] / diff).astype(np.float32)
    if mode == "track_z":
        from ..geometry.normalize import normalize_with_depth

        flow = torch.from_numpy(np.ascontiguousarray(
            sample.coords[:num_frames]))[None]
        return normalize_with_depth(flow, h_ori=h_ori, w_ori=w_ori)[0] \
            .numpy().astype(np.float32)
    if mode == "delta":
        return sample.coords_delta[:num_frames]
    raise ValueError(f"unknown normalization mode {mode}")


class VAEFlowDataset:
    """``VAEFlowSample`` by index, from a video-list file."""

    def __init__(self, video_column: str, posfix: str = "",
                 data_root: Optional[str] = None, height: int = 384,
                 width: int = 512, max_frames: int = 17):
        self.paths = sceneflow_paths_from_list(video_column, posfix,
                                               data_root)
        self.height, self.width = height, width
        self.max_frames = max_frames

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> VAEFlowSample:
        return load_vae_flow_sample(self.paths[idx], self.height,
                                    self.width, self.max_frames)
