"""The port's nn primitives (norms, sinusoidal embedding, 3-axis RoPE) and
its ``jax.image.resize`` counterpart against the JAX package on the CPU.

Tolerances: fp32, atol 1e-6 on the RMS norm and 1e-5 on RoPE and the
layer norm (same formulas, reductions ordered differently), 1e-4 on the
sinusoidal embedding (see there), 1e-5 on the resize (a separable
contraction ordered differently from XLA's einsum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from more4d_tpu.nn import layers as jl
from more4d_tpu.nn import rope as jr
from more4d_tpu_torch.nn import layers as tl
from more4d_tpu_torch.nn import rope as tr
from more4d_tpu_torch.nn.resize import resize


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_norms_and_embedding_match_jax():
    x = _rand(2, 5, 32) * 3 + 1
    w, b = _rand(32, seed=1), _rand(32, seed=2)
    want = np.asarray(jl.RMSNorm(32, eps=1e-6, dtype=jnp.float32).apply(
        {"params": {"weight": w}}, x))
    rms = tl.RMSNorm(32, 1e-6, torch.float32)
    rms.weight.data = torch.from_numpy(w)
    assert np.abs(rms(torch.from_numpy(x)).detach().numpy() - want).max() \
        < 1e-6
    want = np.asarray(jl.layer_norm(x, 1e-6, w, b))
    got = tl.layer_norm(torch.from_numpy(x), 1e-6, torch.from_numpy(w),
                        torch.from_numpy(b)).numpy()
    assert np.abs(got - want).max() < 1e-5
    pos = np.array([0.0, 3.0, 999.0], np.float32)
    want = np.asarray(jl.sinusoidal_embedding(256, pos))
    got = tl.sinusoidal_embedding(256, torch.from_numpy(pos)).numpy()
    # cos/sin of fp32 arguments near 1e3, whose ulp is 6e-5: the two
    # libraries' argument reductions differ by about that much
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("riflex", [None, 4])
def test_rope_matches_jax(riflex):
    kw = dict(riflex_k=riflex, riflex_l_test=13) if riflex else {}
    grid, seq = (3, 4, 5), 64                    # 60 tokens + 4 padded
    cj, sj = jr.rope_angles_3d(jr.RopeTables.create(128, **kw), grid, seq)
    ct, st = tr.rope_angles_3d(tr.RopeTables.create(128, **kw), grid, seq)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    x = _rand(2, seq, 3, 128)
    want = np.asarray(jr.apply_rope(x, cj, sj))
    got = tr.apply_rope(torch.from_numpy(x), ct, st).numpy()
    assert np.abs(got - want).max() < 1e-5
    # padded tokens get the identity rotation
    np.testing.assert_array_equal(got[:, 60:], x[:, 60:])


@pytest.mark.parametrize("src,dst", [
    ((1, 13, 368, 512, 4), (1, 13, 46, 64, 4)),     # stage-2 mask resize
    ((1, 1, 368, 512, 4), (1, 1, 46, 64, 4)),       # its first frame
    ((300, 400, 3), (368, 512, 3)),                 # stage-1 image resize
    ((1, 1, 368, 512, 3), (1, 1, 368, 512, 3)),     # depth image (identity)
    ((1, 1, 200, 260, 3), (1, 1, 368, 512, 3)),     # depth image, upsampled
    ((2, 14, 14, 16), (2, 23, 32, 16)),             # MPM features
], ids=["mask", "mask_first", "image", "depth_same", "depth_up", "mpm"])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.RandomState(0).rand(*src).astype(np.float32)
    method = "trilinear" if len(src) == 5 else "bilinear"
    want = np.asarray(jax.image.resize(x, dst, method))
    got = resize(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5


def test_interpolate_would_not_match():
    """Why the port has its own resize: F.interpolate does not antialias
    when it downsamples, and misses the JAX mask resize by far."""
    x = (np.random.RandomState(1).rand(1, 1, 368, 512, 4) > 0.5).astype(
        np.float32)
    want = np.asarray(jax.image.resize(x, (1, 1, 46, 64, 4), "trilinear"))
    naive = F.interpolate(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                          size=(1, 46, 64), mode="trilinear",
                          align_corners=False).permute(0, 2, 3, 4, 1)
    assert np.abs(naive.numpy() - want).max() > 0.1
