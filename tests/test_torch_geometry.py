"""The port's geometry (projection, depth lift, inverse flow
normalisation, z-buffer render, camera trajectories) and Euler sampler
against the JAX package on the CPU.

Tolerances: fp32, atol 1e-5 on coordinates and colours (matrix inverses
and products ordered differently); the z-buffer's masks must agree
exactly, and so must the trajectories (the same numpy code).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.diffusion import flow_match as jfm
from more4d_tpu.geometry import cameras as jcam
from more4d_tpu.geometry import normalize as jnorm
from more4d_tpu.geometry import projection as jproj
from more4d_tpu.geometry import render as jrender
from more4d_tpu_torch.diffusion import flow_match as tfm
from more4d_tpu_torch.geometry import cameras as tcam
from more4d_tpu_torch.geometry import normalize as tnorm
from more4d_tpu_torch.geometry import projection as tproj
from more4d_tpu_torch.geometry import render as trender

H, W = 24, 32


def test_trajectories_are_the_jax_trajectories():
    assert tcam.TRAJECTORY_TYPES == jcam.TRAJECTORY_TYPES
    assert len(tcam.TRAJECTORY_TYPES) == 11
    center = np.array([0.1, -0.2, 2.5])
    for name, kw in tcam.TRAJECTORY_TYPES:
        np.testing.assert_array_equal(
            tcam.generate_trajectory(name, center, 7, **kw),
            jcam.generate_trajectory(name, center, 7, **kw))


def test_projection_and_lift_match_jax():
    rs = np.random.RandomState(0)
    depth = (1.0 + 5.0 * rs.rand(17, 23)).astype(np.float32)
    want = np.array(jproj.back_project_coords(jnp.asarray(depth), H, W))
    got = tproj.back_project_coords(torch.from_numpy(depth), H, W).numpy()
    assert np.abs(got - want).max() < 1e-5
    ext = jcam.generate_trajectory("circle_rotating", want.mean((0, 1)), 3)
    pts = want.reshape(-1, 3)
    uv_j, d_j = jproj.project(pts, ext[2], jproj.get_intrinsic_matrix(H, W))
    uv_t, d_t = tproj.project(torch.from_numpy(pts),
                              torch.from_numpy(ext[2]),
                              tproj.get_intrinsic_matrix(H, W))
    assert np.abs(uv_t.numpy() - np.asarray(uv_j)).max() < 1e-5
    assert np.abs(d_t.numpy() - np.asarray(d_j)).max() < 1e-5


def test_inverse_flow_norm_matches_jax():
    rs = np.random.RandomState(1)
    rel = rs.randn(1, 3, H, W, 3).astype(np.float32)
    first = rs.randn(1, H, W, 3).astype(np.float32)
    want, dj = jnorm.inverse_flow_norm(rel, first)
    got, dt = tnorm.inverse_flow_norm(torch.from_numpy(rel),
                                      torch.from_numpy(first))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)


@pytest.mark.parametrize("sweep", [False, True])
def test_zbuffer_matches_jax(sweep):
    """Min-depth resolve with mean colour over ties (two points share
    every pixel's depth in the duplicated cloud), hole mask exact."""
    rs = np.random.RandomState(2)
    n = 500
    pts = np.stack([rs.uniform(-0.6, 0.6, n), rs.uniform(-0.4, 0.4, n),
                    rs.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    pts = np.concatenate([pts, pts])                 # exact depth ties
    cols = rs.rand(2 * n, 3).astype(np.float32)
    t = 3
    video = np.stack([pts * (1 + 0.05 * i) for i in range(t)])
    exts = jcam.generate_trajectory("circle_rotating", pts.mean(0), t)
    intr_j = jproj.get_intrinsic_matrix(H, W)
    intr_t = tproj.get_intrinsic_matrix(H, W)
    if sweep:
        exts = np.concatenate([exts, jcam.generate_trajectory(
            "static", pts.mean(0), t)])
        img_j, hole_j = jrender.zbuffer_render_sweep(video, cols, exts,
                                                     intr_j, H, W)
        img_t, hole_t = trender.zbuffer_render_sweep(
            torch.from_numpy(video), torch.from_numpy(cols),
            torch.from_numpy(exts), intr_t, H, W)
    else:
        img_j, hole_j = jrender.zbuffer_render_video(video, cols, exts,
                                                     intr_j, H, W)
        img_t, hole_t = trender.zbuffer_render_video(
            torch.from_numpy(video), torch.from_numpy(cols),
            torch.from_numpy(exts), intr_t, H, W)
    np.testing.assert_array_equal(hole_t.numpy(), np.asarray(hole_j))
    assert np.abs(img_t.numpy() - np.asarray(img_j)).max() < 1e-5
    assert 0.05 < hole_t.float().mean() < 0.95


def test_euler_sampler_matches_jax():
    for steps in (2, 50):
        s_j = jfm.get_scheduler("flow", steps, 3.0)
        s_t = tfm.get_scheduler("flow", steps, 3.0)
        np.testing.assert_array_equal(s_t.sigmas, s_j.sigmas)
        np.testing.assert_array_equal(s_t.timesteps, s_j.timesteps)
    rs = np.random.RandomState(3)
    x, v = rs.randn(2, 4).astype(np.float32), rs.randn(2, 4).astype(
        np.float32)
    for i in range(steps):
        x_j, _ = s_j.step(i, x, v, ())
        x_t, _ = s_t.step(i, torch.from_numpy(x), torch.from_numpy(v), ())
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
        x = np.array(x_j)
    # the multistep samplers are ported (tests/test_torch_schedulers.py
    # holds their steps to JAX's): the same schedule as the JAX package
    for name in ("flow_unipc", "flow_dpm++"):
        s_t, s_j = tfm.get_scheduler(name, 10, 3.0), jfm.get_scheduler(
            name, 10, 3.0)
        assert type(s_t).__name__ == type(s_j).__name__
        np.testing.assert_array_equal(s_t.sigmas, s_j.sigmas)
