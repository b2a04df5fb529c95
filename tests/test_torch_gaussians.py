"""The port's differentiable point-splat renderer
(``more4d_tpu_torch/geometry/gaussians.py``) against the JAX package's
``gs_render`` and ``gs_render_video`` on the CPU, forward and gradient
with respect to the points and colours, and the four properties
``tests/test_gaussians.py`` holds JAX to.

Tolerances, fp32: images and alphas 1e-4 absolute, gradients 1e-4
relative to the largest gradient. The soft z-test divides depth
differences by tau, so the projection's rounding (~2e-7 of a depth near
2, an inverse and products in another order) becomes ~4e-4 of a weight at
tau 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.geometry import gaussians as jgs
from more4d_tpu.geometry.render import zbuffer_render as jzbuffer
from more4d_tpu_torch.geometry import gaussians as tgs
from more4d_tpu_torch.geometry.projection import get_intrinsic_matrix
from more4d_tpu_torch.geometry.render import zbuffer_render

INTR = np.asarray([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], np.float32)
EXT = np.eye(4, dtype=np.float32)
H, W = 12, 16


def _scene(seed, n=60, frames=None):
    """Points in front of the camera, some sharing pixels at different
    depths, with colours; [T, N, 3] with ``frames``."""
    rs = np.random.RandomState(seed)
    shape = (n,) if frames is None else (frames, n)
    z = rs.uniform(1.0, 3.0, shape).astype(np.float32)
    x = (rs.uniform(-0.45, 0.45, shape) * z).astype(np.float32)
    y = (rs.uniform(-0.45, 0.45, shape) * z).astype(np.float32)
    cols = rs.rand(n, 3).astype(np.float32)
    return np.stack([x, y, z], -1), cols


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _ext(seed):
    """A camera moved and turned a little, cam -> world."""
    rs = np.random.RandomState(seed)
    a = rs.uniform(-0.1, 0.1)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]]
    ext[:3, 3] = rs.uniform(-0.1, 0.1, 3)
    return ext


@pytest.mark.parametrize("kw", [dict(), dict(scale=0.02, tau=0.1),
                                dict(scale=1e-5, tau=1e-5, footprint=5,
                                     background=0.5)])
def test_render_matches_jax(kw):
    pts, cols = _scene(0)
    intr = get_intrinsic_matrix(H, W).numpy()
    ext = _ext(1)
    img, alpha = tgs.gs_render(_t(pts), _t(cols), _t(ext), _t(intr), H, W,
                               **kw)
    jimg, jalpha = jgs.gs_render(jnp.asarray(pts), jnp.asarray(cols),
                                 jnp.asarray(ext), jnp.asarray(intr), H, W,
                                 **kw)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), atol=1e-4,
                               rtol=0)
    assert (alpha.numpy() > 0.5).any()


def test_gradients_match_jax():
    """d/d(points, colours) of sum(image^2 * weights): the splat weights,
    the soft z-test against the per-pixel minimum (its gradient shared
    among ties, as JAX's segment_min and maximum share it) and the
    normalisation."""
    pts, cols = _scene(2, n=40)
    wts = np.random.RandomState(3).rand(H, W, 3).astype(np.float32)
    kw = dict(scale=0.02, tau=0.1)

    def jloss(p, c):
        img, alpha = jgs.gs_render(p, c, jnp.asarray(EXT), jnp.asarray(INTR),
                                   H, W, **kw)
        return jnp.sum(img ** 2 * wts) + jnp.sum(alpha)

    jgp, jgc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(pts),
                                               jnp.asarray(cols))
    p, c = _t(pts).requires_grad_(), _t(cols).requires_grad_()
    img, alpha = tgs.gs_render(p, c, _t(EXT), _t(INTR), H, W, **kw)
    ((img ** 2 * _t(wts)).sum() + alpha.sum()).backward()
    for got, want in ((p.grad, jgp), (c.grad, jgc)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * np.abs(want).max(), rtol=0)


def test_video_matches_jax():
    """``gs_render_video``: a frame a camera, forward and the points'
    gradient."""
    pts, cols = _scene(4, n=30, frames=3)
    exts = np.stack([_ext(s) for s in range(3)])
    kw = dict(scale=0.02, tau=0.1)

    def jloss(p):
        img, alpha = jgs.gs_render_video(p, jnp.asarray(cols),
                                         jnp.asarray(exts),
                                         jnp.asarray(INTR), H, W, **kw)
        return jnp.sum(img ** 2) + jnp.sum(alpha), (img, alpha)

    (_, (jimg, jalpha)), jgp = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(pts))
    p = _t(pts).requires_grad_()
    img, alpha = tgs.gs_render_video(p, _t(cols), _t(exts), _t(INTR), H, W,
                                     **kw)
    assert img.shape == (3, H, W, 3) and alpha.shape == (3, H, W)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(jalpha),
                               atol=1e-4, rtol=0)
    ((img ** 2).sum() + alpha.sum()).backward()
    jgp = np.asarray(jgp)
    np.testing.assert_allclose(p.grad.numpy(), jgp,
                               atol=1e-4 * np.abs(jgp).max(), rtol=0)


def _occlusion():
    pts = _t([[0.1, 0.1, 1.0], [0.1, 0.1, 2.0]])     # one ray
    cols = _t([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    img, alpha = tgs.gs_render(pts, cols, _t(EXT), _t(INTR), 8, 8,
                               scale=1e-4, tau=1e-4)
    # uv = 0.6 -> pixel (4, 4)
    px = img[4, 4].numpy()
    assert px[0] > 0.99 and px[1] < 0.01
    assert float(alpha[4, 4]) > 0.5


def _zbuffer_hard_limit():
    """Points at pixel centres: the splat render agrees with the z-buffer
    render (hard z-test, tiny sigma: no blending across pixels)."""
    h = w = 16
    rng = np.random.RandomState(0)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    u = (xs.ravel() + 0.5) / w
    v = (ys.ravel() + 0.5) / h
    z = np.full(h * w, 2.0, np.float32)
    pts = np.stack([(u - 0.5) * z, (v - 0.5) * z, z], axis=-1)
    cols = rng.rand(h * w, 3).astype(np.float32)
    front = np.array([[(u[3 * w + 3] - 0.5), (v[3 * w + 3] - 0.5), 1.0]],
                     np.float32)
    pts = np.concatenate([pts, front]).astype(np.float32)
    cols = np.concatenate([cols, np.ones((1, 3), np.float32)])
    img, alpha = tgs.gs_render(_t(pts), _t(cols), _t(EXT), _t(INTR), h, w,
                               scale=1e-5, tau=1e-5)
    zb, hole = zbuffer_render(_t(pts), _t(cols), _t(EXT), _t(INTR), h, w)
    assert not hole.numpy().any()
    np.testing.assert_allclose(img.numpy(), zb.numpy(), atol=0.02)
    np.testing.assert_allclose(img[3, 3].numpy(), [1, 1, 1], atol=0.02)
    assert (alpha.numpy() > 0.5).all()
    # and JAX's z-buffer agrees with the port's on the same scene
    jzb, _ = jzbuffer(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(EXT),
                      jnp.asarray(INTR), h, w)
    np.testing.assert_allclose(zb.numpy(), np.asarray(jzb), atol=1e-5)


def _differentiable():
    pts = _t([[0.05, 0.05, 1.2], [-0.1, 0.0, 1.8]]).requires_grad_()
    cols = _t([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1]]).requires_grad_()
    img, _ = tgs.gs_render(pts, cols, _t(EXT), _t(INTR), 8, 8, scale=0.01,
                           tau=0.1)
    (img ** 2).sum().backward()
    assert torch.isfinite(pts.grad).all()
    assert cols.grad.abs().max() > 0


def _background():
    img, alpha = tgs.gs_render(_t([[0.1, 0.1, 1.0]]), _t([[1.0, 1.0, 1.0]]),
                               _t(EXT), _t(INTR), 8, 8, background=0.0)
    assert float(img[0, 0, 0]) == 0.0
    assert float(alpha[0, 0]) == 0.0


@pytest.mark.parametrize("check", [_occlusion, _zbuffer_hard_limit,
                                   _differentiable, _background],
                         ids=["occlusion_front_point_wins",
                              "matches_zbuffer_in_hard_limit",
                              "render_is_differentiable",
                              "empty_pixels_get_background"])
def test_properties(check):
    """The properties ``tests/test_gaussians.py`` holds the JAX renderer
    to: the front point wins a shared ray, the hard limit is the z-buffer
    render, the render is differentiable, an empty pixel is background."""
    check()
