"""Camera projection / unprojection (PyTorch port of
``more4d_tpu/geometry/projection.py``).

Intrinsics are *normalized* (uv in [0, 1]); extrinsics are cam->world
rigid transforms (world2cam is the inverse).
"""

from __future__ import annotations

import torch

from ..nn.resize import resize

# Reference capture resolution used to derive intrinsics.
DEFAULT_H_ORI, DEFAULT_W_ORI = 540, 960


def homogenize_points(points):
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def project(points, extrinsics, intrinsics, epsilon: float = 1.19e-7):
    """World points -> (normalized uv, camera depth). points [..., N, 3];
    extrinsics [..., 4, 4] broadcast against the points' leading dims."""
    p = homogenize_points(points)
    w2c = torch.linalg.inv(extrinsics)
    cam = torch.einsum("...ij,...nj->...ni", w2c, p)[..., :-1]
    depth = cam[..., -1]
    ndc = cam / (cam[..., -1:] + epsilon)
    ndc = torch.nan_to_num(ndc, posinf=1e8, neginf=-1e8)
    uv = torch.einsum("ij,...nj->...ni", intrinsics, ndc)[..., :-1]
    return uv, depth


def get_intrinsic_matrix(height: int, width: int,
                         h_ori: int = DEFAULT_H_ORI,
                         w_ori: int = DEFAULT_W_ORI, device=None):
    """Normalized intrinsics matching the reference capture aspect."""
    if w_ori / width > h_ori / height:
        fx = 1.0
        fy = w_ori / h_ori / (width / height)
    else:
        fy = 1.0
        fx = h_ori / w_ori / (height / width)
    return torch.tensor([[fx, 0.0, 0.5], [0.0, fy, 0.5], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def back_project_coords(depth_map, height: int, width: int, intrinsics=None):
    """Depth map [H', W'] -> per-pixel 3D points [H, W, 3]. The uv grid
    uses linspace(0, 1) with both endpoints, as the reference does."""
    depth = resize(depth_map[None, None].float(), (1, 1, height, width))[0, 0]
    dev = depth.device
    if intrinsics is None:
        intrinsics = get_intrinsic_matrix(height, width, device=dev)
    u = torch.linspace(0.0, 1.0, width, device=dev)
    v = torch.linspace(0.0, 1.0, height, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    pixels = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)
    rays = pixels @ torch.linalg.inv(intrinsics).T
    return rays * depth[..., None]
