"""The port's STraG data helpers against the JAX package's, on the CPU:
the aspect buckets, the resumable sampler (its state through a round trip)
and the batch grouping, exact; ``get_random_mask`` for every mask type
under one ``RandomState``, bit for bit; the Plücker camera maps
(``process_pose_params``) and their temporal fold within 1e-6 (float32,
the same numpy arithmetic); and the port DiT's control adapter on those
maps against JAX's (the ``tests/test_camera_cond.py`` model: float32,
atol 2e-5 on outputs of magnitude ~1, sums in other orders).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.data import buckets as jax_buckets
from more4d_tpu.data import camera_cond as jax_cam
from more4d_tpu.data import masks as jax_masks
from more4d_tpu_torch.data import (ASPECT_RATIO_512, AspectRatioBatchSampler,
                                   ResumableSampler, closest_bucket,
                                   get_random_mask)
from more4d_tpu_torch.data import camera_cond as cam
from more4d_tpu_torch.data.masks import MASK_PROBS


def test_bucket_table_and_closest_bucket_match_jax():
    assert ASPECT_RATIO_512 == jax_buckets.ASPECT_RATIO_512
    for h, w in [(368, 512), (512, 368), (480, 480), (256, 1024),
                 (1000, 250), (720, 1280)]:
        assert closest_bucket(h, w) == jax_buckets.closest_bucket(h, w)


def test_resumable_sampler_and_its_state_match_jax():
    """Two epochs of both samplers give the same indices; a sampler whose
    state is saved mid-epoch and loaded into a fresh one goes on with the
    same indices as the one that was not stopped."""
    ours, theirs = ResumableSampler(7, seed=3), jax_buckets.ResumableSampler(
        7, seed=3)
    a = list(itertools.islice(iter(ours), 10))
    assert a == list(itertools.islice(iter(theirs), 10))
    assert sorted(a[:7]) == list(range(7))
    state = ours.state_dict()
    assert state == theirs.state_dict() == {"epoch": 1, "pos_start": 3,
                                            "seed": 3}
    fresh = ResumableSampler(7, seed=0)
    fresh.load_state_dict(state)
    assert (list(itertools.islice(iter(fresh), 9))
            == list(itertools.islice(iter(theirs), 9)))
    plain = ResumableSampler(5, shuffle=False)
    assert list(itertools.islice(iter(plain), 6)) == [0, 1, 2, 3, 4, 0]


def test_aspect_ratio_batches_match_jax():
    ratios = list(np.random.RandomState(0).uniform(0.3, 3.5, 40))
    ours = AspectRatioBatchSampler(ResumableSampler(40, seed=1), ratios, 3)
    theirs = jax_buckets.AspectRatioBatchSampler(
        jax_buckets.ResumableSampler(40, seed=1), ratios, 3)
    got = list(itertools.islice(iter(ours), 12))
    assert got == list(itertools.islice(iter(theirs), 12))
    for key, idx in got:
        assert len(idx) == 3
        assert all(closest_bucket(ratios[i], 1.0) == key for i in idx)


@pytest.mark.parametrize("shape", [(9, 16, 24), (1, 16, 24)])
def test_random_masks_match_jax_bit_for_bit(shape):
    """Every mask type (drawn until each has come up) and the
    image_start_only masks, from one RandomState each side."""
    assert MASK_PROBS == jax_masks.MASK_PROBS
    ours, theirs = np.random.RandomState(11), np.random.RandomState(11)
    seen = set()
    probe = np.random.RandomState()
    for _ in range(200):
        # the strategy this draw takes, read from a copy of the stream
        probe.set_state(ours.get_state())
        seen.add(int(probe.choice(10, p=MASK_PROBS)) if shape[0] != 1
                 else int(probe.choice([0, 1], p=[0.2, 0.8])))
        want = jax_masks.get_random_mask(shape, rng=theirs)
        got = get_random_mask(shape, rng=ours)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert len(seen) == (10 if shape[0] != 1 else 2)
    np.testing.assert_array_equal(
        get_random_mask(shape, image_start_only=True),
        jax_masks.get_random_mask(shape, image_start_only=True))


def _pose_rows(n, seed=0):
    """RealEstate10K-style rows [ts, fx, fy, cx, cy, 0, 0, w2c(3x4)]:
    normalised intrinsics, a camera drifting and turning."""
    rs = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        a = 0.05 * i + 0.01 * rs.randn()
        rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]])
        t = np.array([0.1 * i, 0.02 * rs.randn(), 0.05 * i])
        rows.append([i, 0.9, 1.6, 0.5, 0.5, 0, 0,
                     *np.concatenate([rot, t[:, None]], 1).ravel()])
    return rows


@pytest.mark.parametrize("size", [(16, 24), (24, 16)])
def test_plucker_maps_and_fold_match_jax(size):
    h, w = size
    rows = _pose_rows(9)
    got = cam.process_pose_params(rows, width=w, height=h)
    want = jax_cam.process_pose_params(rows, width=w, height=h)
    assert got.shape == (9, h, w, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cam.fold_camera_video(got),
                               jax_cam.fold_camera_video(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(cam.get_relative_pose(
        [cam.Camera(r) for r in rows]), jax_cam.get_relative_pose(
        [jax_cam.Camera(r) for r in rows]))


def test_control_adapter_on_the_maps_matches_jax():
    """The folded Plücker maps of 9 poses at 16x16 as ``y_camera`` through
    both DiTs (the control adapter's patchify-and-add before the blocks):
    the same output within 2e-5."""
    from more4d_tpu.config import dit_tiny as jax_dit_tiny
    from more4d_tpu.models import WanDiT as JaxWanDiT
    from more4d_tpu_torch.config import dit_tiny
    from more4d_tpu_torch.convert import dit_state_dict
    from more4d_tpu_torch.models import WanDiT

    kw = dict(control_adapter=True, text_len=16, clip_tokens=9, dim=32,
              ffn_dim=64, num_heads=2, num_layers=2)
    jcfg = jax_dit_tiny(dtype=jnp.float32, **kw)
    rng = np.random.RandomState(1)
    y_cam = cam.fold_camera_video(cam.process_pose_params(
        _pose_rows(9, seed=2), width=16, height=16))[None]      # [1,3,h,w,24]
    x = rng.randn(1, 3, 16, 16, 16).astype(np.float32)
    y = rng.randn(1, 3, 16, 16, jcfg.in_dim - 16).astype(np.float32)
    t = np.asarray([100.0], np.float32)
    ctx = rng.randn(1, 7, jcfg.text_dim).astype(np.float32)
    clip = rng.randn(1, jcfg.clip_tokens, jcfg.clip_dim).astype(np.float32)
    model = JaxWanDiT(jcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, t, ctx,
                            y=y, y_camera=y_cam, clip_fea=clip)
    leaves, td = jax.tree_util.tree_flatten(shapes)
    prs = np.random.RandomState(3)
    params = jax.tree_util.tree_unflatten(
        td, [jnp.asarray(prs.normal(0, 0.05, l.shape), jnp.float32)
             for l in leaves])
    want = np.asarray(jax.jit(model.apply)(params, x, t, ctx, y=y,
                                           y_camera=y_cam, clip_fea=clip))
    tcfg = dit_tiny(dtype=torch.float32, **kw)
    dit = WanDiT(tcfg)
    dit.load_state_dict(dit_state_dict(params, tcfg), strict=True)
    with torch.no_grad():
        got = dit(*map(torch.from_numpy, (x, t, ctx)),
                  y=torch.from_numpy(y), y_camera=torch.from_numpy(y_cam),
                  clip_fea=torch.from_numpy(clip)).numpy()
        without = dit(*map(torch.from_numpy, (x, t, ctx)),
                      y=torch.from_numpy(y),
                      clip_fea=torch.from_numpy(clip)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert np.abs(got - without).max() > 1e-3     # the maps reach the output
