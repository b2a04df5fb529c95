"""Camera trajectory generators (host-side numpy), a copy of
``more4d_tpu/geometry/cameras.py``: the five generators of the reference
inference script and the 11-entry ``TRAJECTORY_TYPES`` sweep built from
their parameterized variants. Extrinsics are cam->world 4x4 float32.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


def _look_at(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    up = np.array([0.0, 1.0, 0.0])
    forward = target - cam_pos
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, up)
    right = right / np.linalg.norm(right)
    up_c = np.cross(right, forward)
    up_c = up_c / np.linalg.norm(up_c)
    r = np.array([-right, up_c, forward]).T
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = r
    ext[:3, 3] = cam_pos
    return ext


def static_trajectory(center, n_frames: int, **kw) -> List[np.ndarray]:
    return [np.eye(4, dtype=np.float32) for _ in range(n_frames)]


def forward_backward_trajectory(center, n_frames: int,
                                radius_base: float = None,
                                z_progress: bool = True,
                                radius_mult: float = 1.0
                                ) -> List[np.ndarray]:
    # motion scaled to the scene's depth: radius = 0.4 * |center_z|
    if radius_base is None:
        radius_base = 0.4 * abs(float(np.asarray(center)[2]))
    radius_base *= radius_mult
    out = []
    for i in range(n_frames):
        if i < n_frames // 4:
            cam_z = radius_base * i / n_frames if z_progress else 0.0
        elif i < 3 * n_frames // 4:
            cam_z = (0.5 * radius_base - radius_base * i / n_frames
                     if z_progress else 0.0)
        else:
            cam_z = -radius_base + radius_base * i / n_frames \
                if z_progress else 0.0
        ext = np.eye(4, dtype=np.float32)
        ext[:3, 3] = [0.0, 0.0, cam_z]
        out.append(ext)
    return out


def circle_rotating_trajectory(center, n_frames: int,
                               radius_base: float = None,
                               z_progress: bool = True,
                               radius_mult: float = 1.0
                               ) -> List[np.ndarray]:
    center = np.asarray(center, np.float64)
    # radius = 0.05 * |center_z|
    if radius_base is None:
        radius_base = 0.05 * abs(float(center[2]))
    radius_base *= radius_mult
    out = []
    for i in range(n_frames):
        angle = 2 * math.pi * i / n_frames
        cam_pos = np.array([radius_base * math.cos(angle),
                            radius_base * math.sin(angle),
                            3 * radius_base * i / n_frames
                            if z_progress else 0.0])
        out.append(_look_at(cam_pos, center))
    return out


def surrounding_trajectory(center, n_frames: int, **kw) -> List[np.ndarray]:
    center = np.asarray(center, np.float64)
    out = []
    for i in range(n_frames):
        angle = (-math.pi * i / n_frames / 4
                 - math.atan2(center[2], center[0]))
        radius = math.sqrt(center[0] ** 2 + center[2] ** 2)
        cam_pos = np.array([center[0] + radius * math.cos(angle), 0.0,
                            center[2] + radius * math.sin(angle)])
        out.append(_look_at(cam_pos, center))
    return out


def camera_rotate_trajectory(center, n_frames: int,
                             rotate_max_degree: float = 30.0,
                             z_progress: bool = True) -> List[np.ndarray]:
    out = []
    for i in range(n_frames):
        angle = math.radians(rotate_max_degree) * math.sin(
            math.pi * i / n_frames)
        rz = np.array([
            [math.cos(angle), -math.sin(angle), 0.0],
            [math.sin(angle), math.cos(angle), 0.0],
            [0.0, 0.0, 1.0],
        ])
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = rz
        out.append(ext)
    return out


_GENERATORS = {
    "static": static_trajectory,
    "forward_backward": forward_backward_trajectory,
    "circle_rotating": circle_rotating_trajectory,
    "surrounding": surrounding_trajectory,
    "camera_rotate": camera_rotate_trajectory,
}

# The 11-trajectory sweep rendered per sample: the 5 real generators fill
# all 11 slots through parameterized variants (radius_mult scales the
# depth-proportional radius).
TRAJECTORY_TYPES = [
    ("static", {}),
    ("forward_backward", {}),
    ("forward_backward", {"z_progress": False}),
    ("circle_rotating", {}),
    ("circle_rotating", {"z_progress": False}),
    ("circle_rotating", {"radius_mult": 0.5}),
    ("circle_rotating", {"radius_mult": 0.5, "z_progress": False}),
    ("surrounding", {}),
    ("camera_rotate", {}),
    ("camera_rotate", {"rotate_max_degree": 15.0}),
    ("forward_backward", {"radius_mult": 1.5}),
]


def get_trajectory_generator(name: str):
    return _GENERATORS[name]


def generate_trajectory(name: str, center, n_frames: int, **kw) -> np.ndarray:
    """Returns stacked extrinsics [n_frames, 4, 4] float32."""
    return np.stack(_GENERATORS[name](center, n_frames, **kw))
