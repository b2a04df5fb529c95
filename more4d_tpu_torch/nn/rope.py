"""3-axis rotary position embeddings for video DiTs (+ RIFLEx), PyTorch
port of ``more4d_tpu/nn/rope.py``.

Each head's channel pairs split into three groups that rotate with the
temporal / height / width token coordinate. Angle tables are built on the
host in float64 (numpy) exactly as the JAX package builds them; tokens past
f*h*w (padding) get the identity rotation. ``apply_rope``, the rotation,
lives beside K5 (``kernels/rownorm.py``), which fuses it into the qk norm.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.rownorm import apply_rope  # noqa: F401  (K5's plain RoPE)


def _axis_angles(max_pos: int, dim_axis: int, theta: float = 10000.0,
                 riflex_k: Optional[int] = None,
                 riflex_l_test: Optional[int] = None,
                 riflex_scale: Optional[float] = None) -> np.ndarray:
    """Angle table [max_pos, dim_axis//2] for one coordinate axis (float64)."""
    freqs = 1.0 / np.power(theta, np.arange(0, dim_axis, 2, dtype=np.float64)
                           / dim_axis)
    if riflex_k is not None:
        if riflex_l_test is None:
            raise ValueError("riflex_k needs riflex_l_test")
        freqs[riflex_k - 1] = 0.9 * 2.0 * np.pi / riflex_l_test
        if riflex_scale is not None:
            freqs[riflex_k - 1] = freqs[riflex_k - 1] / riflex_scale
    return np.outer(np.arange(max_pos, dtype=np.float64), freqs)


@dataclasses.dataclass(frozen=True)
class RopeTables:
    """Host-side per-axis angle tables."""

    t: np.ndarray  # [max_pos, dt/2]
    h: np.ndarray  # [max_pos, dh/2]
    w: np.ndarray  # [max_pos, dw/2]

    @classmethod
    def create(cls, head_dim: int, max_pos: int = 1024, theta: float = 10000.0,
               riflex_k: Optional[int] = None,
               riflex_l_test: Optional[int] = None,
               riflex_scale: Optional[float] = None) -> "RopeTables":
        d = head_dim
        dt, dh, dw = d - 4 * (d // 6), 2 * (d // 6), 2 * (d // 6)
        return cls(
            t=_axis_angles(max_pos, dt, theta, riflex_k, riflex_l_test,
                           riflex_scale),
            h=_axis_angles(max_pos, dh, theta),
            w=_axis_angles(max_pos, dw, theta),
        )


def rope_angles_3d(tables: RopeTables, grid: Tuple[int, int, int],
                   seq_len: Optional[int] = None, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [seq_len, head_dim//2] float32 for a (f, h, w) token grid.

    Token order is row-major over (f, h, w); channel-pair order is
    [t-pairs | h-pairs | w-pairs]. Tokens beyond f*h*w get the identity
    rotation.
    """
    f, h, w = grid
    ang = np.concatenate([
        np.broadcast_to(tables.t[:f][:, None, None, :],
                        (f, h, w, tables.t.shape[1])),
        np.broadcast_to(tables.h[:h][None, :, None, :],
                        (f, h, w, tables.h.shape[1])),
        np.broadcast_to(tables.w[:w][None, None, :, :],
                        (f, h, w, tables.w.shape[1])),
    ], axis=-1).reshape(f * h * w, -1)
    cos = np.cos(ang).astype(np.float32)
    sin = np.sin(ang).astype(np.float32)
    if seq_len is not None and seq_len > f * h * w:
        pad = seq_len - f * h * w
        cos = np.concatenate([cos, np.ones((pad, cos.shape[1]), np.float32)])
        sin = np.concatenate([sin, np.zeros((pad, sin.shape[1]), np.float32)])
    return (torch.from_numpy(cos).to(device),
            torch.from_numpy(sin).to(device))
