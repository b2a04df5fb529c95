"""The data-parallel trajectory sweep: the port's ``stage2_inpaint_dp``
and ``run_two_stage(sweep_mesh=)`` on two gloo ranks against the JAX
package's serial sweep, at the sizes of ``tests/test_torch_two_stage.py``
(32x32, 5 frames, tiny DiTs and VAE) with the same converted weights,
encoder outputs and numpy noise, as ``tests/test_two_stage.py`` holds
JAX's own DP sweep to its serial one.

Three trajectories on two ranks, so the sweep pads to four by repeating
the last render. A stale seq mesh installed before the sweep must be
cleared for it (Ulysses must not run) and restored after it. Tolerance
2e-4 on videos in [0, 1], as the JAX test's; each rank gathers every
video.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist as td
from more4d_tpu.infer import run_two_stage as jax_run_two_stage
from more4d_tpu.infer.two_stage import \
    stage2_inpaint_batch as jax_stage2_inpaint_batch
from test_torch_two_stage import (DIT4, DIT_INP, H, PROMPT, VAE, W,
                                  slice_pair)  # noqa: F401
from more4d_tpu_torch.convert import (adaptor_state_dict, dit_state_dict,
                                      vae_state_dict)

TRAJ3 = [("static", {}), ("circle_rotating", {}), ("forward_backward", {})]


@pytest.fixture(scope="module")
def sweep(slice_pair):
    """JAX's serial sweep (three trajectories in one stage-2 batch, the
    run's shared noise, and independent noise on its renders), and the
    port's two ranks on the same weights, noise and renders."""
    jm, tm, image, depth = slice_pair
    rs = np.random.RandomState(11)
    noise2 = rs.randn(3, *np.asarray(tm.inpaint_pipeline.prepare_latents(
        None, 1)).shape[1:]).astype(np.float32)
    jm.inpaint_pipeline.prepare_latents = \
        lambda rng, b, *a, **k: jnp.asarray(noise2[:b])
    want = jax_run_two_stage(jm, image, PROMPT, depth=depth,
                             trajectory_types=TRAJ3, use_gs=True,
                             stage2_batch=3)
    renders = [{"name": r["name"], "frames": np.asarray(r["frames"]),
                "mask": np.asarray(r["mask"])} for r in want["renders"]]
    independent = np.asarray(jax_stage2_inpaint_batch(
        jm, want["renders"], PROMPT, shared_noise=False))
    ctrl, inp = tm.control_pipeline, tm.inpaint_pipeline
    spec = dict(
        dit4=DIT4, dit_inp=DIT_INP, vae=VAE, dec_ch=8,
        dit4_state=_np(ctrl.dit.state_dict()),
        dit_inp_state=_np(inp.dit.state_dict()),
        vae_state=_np(ctrl.vae.state_dict()),
        dec_state=_np(tm.decoder_adaptor.state_dict()),
        pcfg=dict(num_inference_steps=2, guidance_scale=5.0,
                  num_frames=ctrl.config.num_frames, height=H, width=W),
        noise1=np.asarray(ctrl.prepare_latents(None, 1)), noise2=noise2,
        text={p: tm.encode_text([p]).numpy() for p in (PROMPT, "")},
        clip=tm.encode_image_clip(np.zeros((1,))).numpy(),
        mpm=tm.extract_mpm(np.zeros((1,))).numpy(),
        renders=renders, prompt=PROMPT, image=image, depth=depth,
        traj=TRAJ3)
    return want, independent, spec


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def ranks(sweep, tmp_path_factory):
    _, _, spec = sweep
    return td.spawn(td.sweep_dp_worker, 2, tmp_path_factory.mktemp("dp"),
                    spec)


def test_stage2_inpaint_dp_matches_jax_serial_sweep(sweep, ranks):
    want, independent, _ = sweep
    shared = np.stack([np.asarray(v["video"]) for v in want["videos"]])
    for got in ranks:
        assert got["restored"], "the stale seq mesh was not restored"
        assert got["independent"].shape == independent.shape == \
            (3, 5, H, W, 3)
        np.testing.assert_allclose(got["independent"], independent,
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(got["shared"], shared, atol=2e-4, rtol=0)


def test_run_two_stage_sweep_mesh_matches_jax(sweep, ranks):
    """run_two_stage(sweep_mesh=) end to end against JAX's serial
    run_two_stage; the renders come from each package's own clouds (see
    tests/test_torch_two_stage.py on their 1e-4 agreement)."""
    want, _, _ = sweep
    for got in ranks:
        assert [n for n, _ in got["run"]] == \
            [v["name"] for v in want["videos"]]
        for (_, video), w in zip(got["run"], want["videos"]):
            np.testing.assert_allclose(video, np.asarray(w["video"]),
                                       atol=2e-4, rtol=0)


@pytest.mark.parametrize("sweep, sp, from_rank_0", [
    (True, 1, True), (False, 2, True), (False, 1, False)])
def test_one_cloud_takes_rank_0s_clouds(tmp_path, sweep, sp, from_rank_0):
    """Under the sweep or a seq mesh every rank renders rank 0's clouds;
    elsewhere each keeps its own."""
    ranks = td.spawn(td.one_cloud_worker, 2, tmp_path, sweep, sp)
    for r, (coords, colors) in enumerate(ranks):
        want = 0.0 if from_rank_0 else float(r)
        assert (coords == want).all() and (colors == want).all()
