"""The port's ViSM data path (``more4d_tpu_torch/data/vism.py``) and its
prefetching (``data/prefetch.py``) against the JAX package's, on the CPU.

Tolerances: the z-buffer's hole mask exactly; its colours to 1e-6 (both
sum the colours of the points at a pixel's least depth in float64 and
round once to float32; the orders of the sums differ). The intrinsics,
frame indices and padding exactly; ``prepare_vism_sample`` to 1e-6 on the
same seed, its text and t2v flag exactly.
"""

import threading
import time

import numpy as np
import pytest
import torch

from more4d_tpu.data import prefetch as jax_prefetch
from more4d_tpu.data import vism as jax_vism
from more4d_tpu_torch.data import prefetch as tprefetch
from more4d_tpu_torch.data import vism

H, W = 24, 32


def _cloud(seed, n=3000, behind=0.1):
    """Points spread over and beyond the frame, some behind the camera, and
    a block of exact duplicates in position with other colours (ties at a
    pixel's least depth)."""
    rs = np.random.RandomState(seed)
    z = rs.uniform(0.5, 4.0, n).astype(np.float32)
    z[: int(n * behind)] *= -1.0
    xy = rs.uniform(-0.8, 0.8, (n, 2)).astype(np.float32) * np.abs(z)[:, None]
    pts = np.concatenate([xy, z[:, None]], 1)
    dup = np.repeat(pts[-50:], 3, axis=0)
    pts = np.concatenate([pts, dup]).astype(np.float32)
    colors = rs.rand(len(pts), 3).astype(np.float32)
    return pts, colors


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_project_point_cloud_matches_jax(seed):
    pts, colors = _cloud(seed)
    want_c, want_m = jax_vism.project_point_cloud(pts, colors, H, W,
                                                  backend="numpy")
    got_c, got_m = vism.project_point_cloud(torch.from_numpy(pts),
                                            torch.from_numpy(colors), H, W)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-6)
    assert 0 < want_m.mean() < 1


def test_project_point_cloud_ties_take_the_mean():
    """Two points at one pixel and one depth: the mean colour; a third
    farther away is hidden."""
    pts = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 2.0]],
                   np.float32)
    colors = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                      np.float32)
    want_c, _ = jax_vism.project_point_cloud(pts, colors, H, W,
                                             backend="numpy")
    got_c, got_m = vism.project_point_cloud(torch.from_numpy(pts),
                                            torch.from_numpy(colors), H, W)
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=1e-7)
    lit = got_c.numpy().reshape(-1, 3)[got_m.numpy()[..., 0].ravel() == 0]
    np.testing.assert_allclose(lit, [[0.5, 0.5, 0.0]], atol=1e-7)


@pytest.mark.parametrize("case", ["behind", "outside"])
def test_project_point_cloud_empty(case):
    pts, colors = _cloud(3, n=200, behind=0.0)
    if case == "behind":
        pts[:, 2] = -np.abs(pts[:, 2])
    else:
        pts[:, 0] = 50.0 * np.abs(pts[:, 2])
    want_c, want_m = jax_vism.project_point_cloud(pts, colors, H, W,
                                                  backend="numpy")
    got_c, got_m = vism.project_point_cloud(torch.from_numpy(pts),
                                            torch.from_numpy(colors), H, W)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    assert want_m.min() == 1.0


def test_project_point_cloud_extrinsic():
    pts, colors = _cloud(4)
    rs = np.random.RandomState(4)
    a = 0.1
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]]
    ext[:3, 3] = rs.uniform(-0.1, 0.1, 3)
    want_c, want_m = jax_vism.project_point_cloud(pts, colors, H, W,
                                                  extrinsic=ext,
                                                  backend="numpy")
    got_c, got_m = vism.project_point_cloud(torch.from_numpy(pts),
                                            torch.from_numpy(colors), H, W,
                                            extrinsic=ext)
    # the rotated points are a float32 matmul on both sides; a point on a
    # pixel edge may round to the other side, so allow a few pixels
    assert (got_m.numpy() != want_m).mean() < 0.01
    same = (got_m.numpy() == want_m).all(-1)
    assert np.abs(got_c.numpy() - want_c)[same].max() < 1e-6 or \
        (np.abs(got_c.numpy() - want_c) > 1e-6).mean() < 0.01


@pytest.mark.parametrize("hw", [(368, 512), (512, 368), (540, 960),
                                (24, 32)])
def test_intrinsics_match_jax(hw):
    np.testing.assert_array_equal(vism.vism_intrinsics(*hw).numpy(),
                                  jax_vism.vism_intrinsics(*hw))


@pytest.mark.parametrize("n,budget", [(5, 9), (9, 9), (12, 9), (30, 9),
                                      (1, 4)])
def test_frame_sampling_and_padding(n, budget):
    assert vism.sample_frame_indices(n, budget) == \
        jax_vism.sample_frame_indices(n, budget)
    frames = np.random.RandomState(n).rand(n, 2, 2, 3).astype(np.float32)
    want = jax_vism.pad_frames(frames, budget)
    np.testing.assert_array_equal(vism.pad_frames(frames, budget), want)
    np.testing.assert_array_equal(
        vism.pad_frames(torch.from_numpy(frames), budget).numpy(), want)


def _sample_inputs(seed, t=5, all_hole=False):
    rs = np.random.RandomState(seed)
    video = rs.rand(t, H, W, 3).astype(np.float32)
    coords = np.stack([_cloud(seed + i, n=1500)[0][:1500]
                       for i in range(t)])
    if all_hole:
        coords[..., 2] = -1.0
    colors = rs.rand(1500, 3).astype(np.float32)
    return video, coords, colors


def _assert_sample_close(got, want):
    for f in ("pixel_values", "projected_images", "mask",
              "mask_pixel_values", "clip_image01"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f), rtol=0, atol=1e-6,
                                   err_msg=f)
    np.testing.assert_array_equal(got.mask.numpy(), want.mask)
    assert got.text == want.text
    assert got.t2v_keep_flag == want.t2v_keep_flag


@pytest.mark.parametrize("all_hole", [False, True])
def test_prepare_vism_sample_matches_jax(all_hole):
    """The live projection, 5 frames padded to 7, over several draws of one
    seed: the dropouts come out in the same order (the all-hole case draws
    the t2v flag too)."""
    video, coords, colors = _sample_inputs(5, all_hole=all_hole)
    rj, rt = np.random.RandomState(11), np.random.RandomState(11)
    flags = []
    for _ in range(6):
        want = jax_vism.prepare_vism_sample(video, "a prompt", coords=coords,
                                            colors=colors, max_num_frames=7,
                                            text_dropout=0.4, rng=rj)
        got = vism.prepare_vism_sample(video, "a prompt", coords=coords,
                                       colors=colors, max_num_frames=7,
                                       text_dropout=0.4, rng=rt,
                                       device="cpu")
        _assert_sample_close(got, want)
        flags.append((got.text, got.t2v_keep_flag))
    assert len(set(flags)) > 1


def test_prepare_vism_sample_prerendered_matches_jax():
    rs = np.random.RandomState(6)
    video = rs.rand(4, H, W, 3).astype(np.float32)
    render = rs.rand(4, H, W, 3).astype(np.float32)
    for mask in (rs.rand(4, H, W) > 0.7,
                 (rs.rand(4, H, W, 3) > 0.9).astype(np.float32)):
        want = jax_vism.prepare_vism_sample(
            video, "p", prerendered=render, prerendered_mask=mask,
            max_num_frames=6, rng=np.random.RandomState(1))
        got = vism.prepare_vism_sample(
            video, "p", prerendered=render,
            prerendered_mask=mask.astype(np.float32), max_num_frames=6,
            rng=np.random.RandomState(1), device="cpu")
        _assert_sample_close(got, want)


def _square(x):
    return x * x


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetch_yields_every_item(workers):
    """One worker keeps the source's order, as JAX's does; more give every
    item once."""
    want = list(jax_prefetch.PrefetchIterator(iter(range(20)), _square,
                                              num_workers=workers))
    got = list(tprefetch.PrefetchIterator(iter(range(20)), _square,
                                          num_workers=workers))
    assert sorted(got) == sorted(want) == [i * i for i in range(20)]
    if workers == 1:
        assert got == want
    assert list(tprefetch.prefetch(iter("abc"), num_workers=1)) == \
        ["a", "b", "c"]


@pytest.mark.parametrize("where", ["producer", "source"])
def test_prefetch_raises_in_the_consumer(where):
    def source():
        yield from range(3)
        if where == "source":
            raise ValueError("bad source")
        yield 3

    def producer(i):
        if where == "producer" and i == 2:
            raise ValueError("bad item")
        return i

    it = tprefetch.PrefetchIterator(source(), producer, num_workers=1,
                                    depth=1)
    seen = []
    with pytest.raises(ValueError):
        for x in it:
            seen.append(x)
    assert seen == [0, 1] if where == "producer" else seen == [0, 1, 2]


def test_prefetch_overlaps_production_with_consumption():
    """Four items each taking 0.2 s to produce and 0.2 s to consume: two
    workers ahead of the consumer finish in well under the serial 1.6 s."""
    busy = []

    def producer(i):
        busy.append(threading.current_thread().name)
        time.sleep(0.2)
        return i

    t0 = time.perf_counter()
    for _ in tprefetch.PrefetchIterator(iter(range(4)), producer,
                                        num_workers=2, depth=2):
        time.sleep(0.2)
    wall = time.perf_counter() - t0
    assert wall < 1.3, wall
    assert len(set(busy)) == 2
