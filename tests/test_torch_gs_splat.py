"""Tile splat (K4): the port's record building and plain compositor
against the JAX Pallas rasteriser in interpret mode on the CPU. The CUDA
kernel itself is held against the plain version in
``test_torch_kernels_cuda.py``, on a card.

Tolerance: atol 2e-5 on colours and alpha in [0, 1]. The JAX kernel forms
the transmittance as exp(cumsum(log1p(-w))), the port as a running product
of (1 - w); the two agree to a few fp32 ulps per record.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.geometry.cameras import generate_trajectory
from more4d_tpu.geometry.projection import get_intrinsic_matrix as jax_intr
from more4d_tpu.kernels.gs_splat import (gs_render_sweep as jax_sweep,
                                         gs_render_tiled as jax_tiled,
                                         gs_render_tiled_video as jax_video)
from more4d_tpu_torch.geometry.projection import get_intrinsic_matrix
from more4d_tpu_torch.kernels.gs_splat import (gs_render_sweep,
                                               gs_render_tiled,
                                               gs_render_tiled_video, splat,
                                               splat_cuda, tile_records)

ATOL = 2e-5
H, W = 48, 64


def _scene(n=3000, seed=0):
    rs = np.random.RandomState(seed)
    pts = np.stack([rs.uniform(-0.5, 0.5, n), rs.uniform(-0.35, 0.35, n),
                    rs.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    cols = rs.rand(n, 3).astype(np.float32)
    return pts, cols


def _planes(n=6000, seed=0):
    rs = np.random.RandomState(seed)
    near = np.stack([rs.uniform(-0.45, 0.05, n // 2),
                     rs.uniform(-0.35, 0.35, n // 2),
                     np.full(n // 2, 1.2)], -1)
    far = np.stack([rs.uniform(-0.45, 0.45, n // 2),
                    rs.uniform(-0.35, 0.35, n // 2), np.full(n // 2, 3.0)],
                   -1)
    cols = np.concatenate([np.tile([1.0, 0.1, 0.1], (n // 2, 1)),
                           np.tile([0.1, 1.0, 0.1], (n // 2, 1))])
    return (np.concatenate([near, far]).astype(np.float32),
            cols.astype(np.float32))


def _both(pts, cols, ext=None, **kw):
    ext = np.eye(4, dtype=np.float32) if ext is None else ext
    intr = np.asarray(jax_intr(H, W))
    img_j, a_j = jax_tiled(jnp.asarray(pts), jnp.asarray(cols),
                           jnp.asarray(ext), jnp.asarray(intr), H, W,
                           interpret=True, **kw)
    img_t, a_t = gs_render_tiled(torch.from_numpy(pts),
                                 torch.from_numpy(cols),
                                 torch.from_numpy(ext),
                                 get_intrinsic_matrix(H, W), H, W, **kw)
    return (np.asarray(img_j), np.asarray(a_j), img_t.numpy(),
            a_t.numpy())


@pytest.mark.parametrize("case", ["planes", "occlusion", "empty_tile",
                                  "drop_farthest", "background"])
def test_plain_matches_jax_kernel(case):
    kw = {}
    if case == "planes":
        pts, cols = _planes()
        kw = dict(scale=2e-2)
    elif case == "occlusion":
        # a red point in front of a green point on the same ray
        pts = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 2.0]], np.float32)
        cols = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
        kw = dict(scale=5e-2)
    elif case == "empty_tile":
        # every point in the left half; the right half's tiles are empty
        pts, cols = _scene()
        pts[:, 0] = -np.abs(pts[:, 0]) - 0.2
    elif case == "drop_farthest":
        # one crowded tile past max_per_tile: the farthest records drop
        rs = np.random.RandomState(1)
        n = 400
        pts = np.stack([rs.uniform(-0.01, 0.01, n),
                        rs.uniform(-0.01, 0.01, n),
                        rs.uniform(1.0, 3.0, n)], -1).astype(np.float32)
        cols = rs.rand(n, 3).astype(np.float32)
        kw = dict(scale=2e-3, max_per_tile=128)
    else:
        pts, cols = _scene(seed=2)
        kw = dict(background=0.5)
    img_j, a_j, img_t, a_t = _both(pts, cols, **kw)
    assert np.abs(img_t - img_j).max() < ATOL
    assert np.abs(a_t - a_j).max() < ATOL
    if case == "empty_tile":
        assert a_t[:, -16:].max() == 0.0


def test_drop_farthest_keeps_the_front_records():
    """With a tile crowded past max_per_tile, the kept records are the
    front-most, in depth order. At scale 1 the splat size is unclamped,
    so sigma = fx / depth gives each record's depth back."""
    rs = np.random.RandomState(3)
    n = 300
    pts = np.stack([rs.uniform(-0.01, 0.01, n), rs.uniform(-0.01, 0.01, n),
                    rs.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    cols = rs.rand(n, 3).astype(np.float32)
    intr = get_intrinsic_matrix(H, W)
    u, v, s, o, c, counts, _ = tile_records(
        torch.from_numpy(pts)[None], torch.from_numpy(cols),
        torch.eye(4)[None], intr, H, W, scale=1.0, max_per_tile=64)
    t = int(counts[0].argmax())
    assert counts[0, t].item() == 64
    depth = (float(intr[0, 0]) * W / s[0, t]).numpy()
    assert np.all(np.diff(depth) >= -1e-4)
    assert depth.max() < np.sort(pts[:, 2])[100]


def test_video_and_sweep_match_jax():
    pts, cols = _scene(n=1500, seed=4)
    t = 3
    center = pts.mean(0)
    exts = generate_trajectory("circle_rotating", center, t)
    frames = np.stack([pts + 0.02 * i for i in range(t)]).astype(np.float32)
    intr = np.asarray(jax_intr(H, W))
    vid_j, al_j = jax_video(jnp.asarray(frames), jnp.asarray(cols),
                            jnp.asarray(exts), jnp.asarray(intr), H, W,
                            interpret=True)
    vid_t, al_t = gs_render_tiled_video(
        torch.from_numpy(frames), torch.from_numpy(cols),
        torch.from_numpy(exts), get_intrinsic_matrix(H, W), H, W)
    assert np.abs(vid_t.numpy() - np.asarray(vid_j)).max() < ATOL
    assert np.abs(al_t.numpy() - np.asarray(al_j)).max() < ATOL
    # a 2-trajectory sweep over the same cloud equals the per-trajectory
    # videos, and the JAX sweep
    exts2 = np.concatenate([exts, generate_trajectory("static", center, t)])
    sw_t, _ = gs_render_sweep(torch.from_numpy(frames),
                              torch.from_numpy(cols),
                              torch.from_numpy(exts2),
                              get_intrinsic_matrix(H, W), H, W)
    sw_j, _ = jax_sweep(jnp.asarray(frames), jnp.asarray(cols),
                        jnp.asarray(exts2), jnp.asarray(intr), H, W,
                        interpret=True)
    np.testing.assert_array_equal(sw_t[:t].numpy(), vid_t.numpy())
    assert np.abs(sw_t.numpy() - np.asarray(sw_j)).max() < ATOL


def test_cpu_tensor_never_reaches_the_kernel():
    pts, cols = _scene(n=200)
    u, v, s, o, c, counts, (_, tx) = tile_records(
        torch.from_numpy(pts)[None], torch.from_numpy(cols),
        torch.eye(4)[None], get_intrinsic_matrix(H, W), H, W)
    before = splat_cuda.launches
    splat(u, v, s, o, c, counts, tx)
    assert splat_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        splat_cuda(u, v, s, o, c, counts, tx)
