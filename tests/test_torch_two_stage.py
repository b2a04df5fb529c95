"""The slice as a whole: the port's ``run_two_stage`` against the JAX
``run_two_stage`` at the sizes of ``tests/test_two_stage.py`` (32x32, 5
frames, tiny DiTs and VAE), with the same converted weights, the same
encoder outputs and the same numpy noise handed to both pipelines.

Stage 1 uses the 4D-STraG variant (motion guidance, i2v with CLIP), stage
2 the i2v InP variant, so the whole path of the 1.3B operating point runs
at tiny widths. Tolerances (fp32 on the CPU): point clouds atol 1e-4 at
magnitude ~2 and inpainted videos (in [0, 1]) atol 1e-4; both sides order
their sums differently, nothing else differs. Renders of the same clouds
atol 1e-5; end to end atol 1e-2, because a splat's sigma is clamped to
0.3 px, so its weight moves by ~1/sigma^2 = 11 per pixel of position and
the clouds' ~1e-5 differences move a few splat weights by ~1e-3. Masks
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.config import PipelineConfig as JaxPipelineConfig
from more4d_tpu.config import VAEConfig as JaxVAEConfig
from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.infer import TwoStageModels as JaxTwoStageModels
from more4d_tpu.infer import run_two_stage as jax_run_two_stage
from more4d_tpu.models import WanDiT as JaxWanDiT
from more4d_tpu.models.adaptors import VAEDecoderAdaptor as JaxDecAdaptor
from more4d_tpu.models.wan_vae import WanVAE as JaxWanVAE
from more4d_tpu.pipelines import WanControlPipeline as JaxControl
from more4d_tpu.pipelines import WanInpaintPipeline as JaxInpaint
from more4d_tpu_torch.config import PipelineConfig, VAEConfig, dit_tiny
from more4d_tpu_torch.convert import (adaptor_state_dict, dit_state_dict,
                                      vae_state_dict)
from more4d_tpu_torch.infer.two_stage import (TwoStageModels,
                                              render_trajectories,
                                              run_two_stage, stage2_inpaint,
                                              stage2_inpaint_batch)
from more4d_tpu_torch.models import (VAEDecoderAdaptor, WanDiT, WanVAE)
from more4d_tpu_torch.pipelines import (WanControlPipeline,
                                        WanInpaintPipeline)

H = W = 32
T = 5
TEXT_DIM, CLIP_DIM, MPM_DIM = 16, 16, 8
VAE = dict(dim=4, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
           temporal_downsample=(False, True, True))
DIT = dict(out_dim=4, dim=32, ffn_dim=64, num_heads=2, num_layers=2,
           text_dim=TEXT_DIM, clip_dim=CLIP_DIM, text_len=8, clip_tokens=5,
           motion_feature_dim=MPM_DIM, model_type="i2v")
DIT4 = dict(DIT, in_dim=16, motion_guidance=True)
DIT_INP = dict(DIT, in_dim=12)
TRAJ = [("static", {}), ("circle_rotating", {})]
PROMPT = "a cat"


def _random_params(init, seed, std, *args, **kw):
    """Random weights of the shapes ``init`` would make; eval_shape skips
    running (and compiling) the flax init."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args, **kw)
    leaves, td = jax.tree_util.tree_flatten(shapes)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        td, [np.asarray(rs.normal(0, std, l.shape), np.float32)
             for l in leaves])


@pytest.fixture(scope="module")
def slice_pair():
    """Both packages' two-stage models with the same weights, encoder
    outputs and noise."""
    rs = np.random.RandomState(0)
    jvae = JaxWanVAE(JaxVAEConfig(**VAE))
    vae_p = _random_params(jvae.init, 1, 0.2, jnp.zeros((1, T, H, W, 3)))
    jcfg4 = jax_dit_tiny(dtype=jnp.float32, **DIT4)
    jcfg_inp = jax_dit_tiny(dtype=jnp.float32, **DIT_INP)
    tl, lh, lw = (T - 1) // 4 + 1, H // 8, W // 8
    lat = jnp.zeros((1, tl, lh, lw, 4))
    ctx = jnp.zeros((1, 8, TEXT_DIM))
    clip0 = jnp.zeros((1, 5, CLIP_DIM))
    p4 = _random_params(JaxWanDiT(jcfg4).init, 4, 0.03, lat,
                        jnp.zeros((1,)), ctx,
                        y=jnp.zeros((1, tl, lh, lw, 12)), clip_fea=clip0,
                        mpm_features=jnp.zeros((1, 196, MPM_DIM)))
    p_inp = _random_params(JaxWanDiT(jcfg_inp).init, 5, 0.03, lat,
                           jnp.zeros((1,)), ctx,
                           y=jnp.zeros((1, tl, lh, lw, 8)), clip_fea=clip0)
    jdec = JaxDecAdaptor(ch=8)
    dec_p = _random_params(jdec.init, 6, 0.1, jnp.zeros((1, T, H, W, 3)))

    text = {PROMPT: rs.randn(1, 8, TEXT_DIM).astype(np.float32),
            "": rs.randn(1, 8, TEXT_DIM).astype(np.float32)}
    clip = rs.randn(1, 5, CLIP_DIM).astype(np.float32)
    mpm = rs.randn(1, 196, MPM_DIM).astype(np.float32)
    noise1 = rs.randn(1, tl, lh, lw, 4).astype(np.float32)
    noise2 = rs.randn(1, tl, lh, lw, 4).astype(np.float32)
    image = rs.rand(H, W, 3).astype(np.float32)
    depth = (1.0 + 5.0 * rs.rand(H, W)).astype(np.float32)

    pcfg = dict(num_inference_steps=2, guidance_scale=5.0, num_frames=T,
                height=H, width=W)
    jvae_m, jctrl_dit, jinp_dit = jvae, JaxWanDiT(jcfg4), JaxWanDiT(jcfg_inp)
    jctrl = JaxControl(jctrl_dit, jvae_m, JaxPipelineConfig(**pcfg))
    jinp = JaxInpaint(jinp_dit, jvae_m, JaxPipelineConfig(**pcfg))
    jctrl.prepare_latents = lambda rng, b, *a, **k: jnp.asarray(noise1[:b])
    jinp.prepare_latents = lambda rng, b, *a, **k: jnp.asarray(noise2[:b])
    jm = JaxTwoStageModels(
        control_pipeline=jctrl, inpaint_pipeline=jinp, dit4d_params=p4,
        dit_inp_params=p_inp, vae_params=vae_p, decoder_adaptor=jdec,
        decoder_adaptor_params=dec_p,
        encode_text=lambda ps: jnp.concatenate([text[p] for p in ps]),
        encode_image_clip=lambda im: jnp.repeat(clip, im.shape[0], 0),
        extract_mpm=lambda im: jnp.repeat(mpm, im.shape[0], 0))

    tcfg4 = dit_tiny(dtype=torch.float32, **DIT4)
    tcfg_inp = dit_tiny(dtype=torch.float32, **DIT_INP)
    dit4, dit_inp = WanDiT(tcfg4), WanDiT(tcfg_inp)
    dit4.load_state_dict(dit_state_dict(p4, tcfg4), strict=True)
    dit_inp.load_state_dict(dit_state_dict(p_inp, tcfg_inp), strict=True)
    vae = WanVAE(VAEConfig(**VAE))
    vae.load_state_dict(vae_state_dict(vae_p, vae.cfg), strict=True)
    dec = VAEDecoderAdaptor(ch=8)
    dec.load_state_dict(adaptor_state_dict(dec_p, decoder=True),
                        strict=True)
    tctrl = WanControlPipeline(dit4, vae, PipelineConfig(**pcfg), "cpu")
    tinp = WanInpaintPipeline(dit_inp, vae, PipelineConfig(**pcfg), "cpu")
    tctrl.prepare_latents = lambda g, b, *a, **k: torch.from_numpy(
        noise1[:b])
    tinp.prepare_latents = lambda g, b, *a, **k: torch.from_numpy(
        noise2[:b])
    tm = TwoStageModels(
        control_pipeline=tctrl, inpaint_pipeline=tinp, decoder_adaptor=dec,
        encode_text=lambda ps: torch.cat([torch.from_numpy(text[p])
                                          for p in ps]),
        encode_image_clip=lambda im: torch.from_numpy(clip).repeat(
            im.shape[0], 1, 1),
        extract_mpm=lambda im: torch.from_numpy(mpm).repeat(
            im.shape[0], 1, 1))
    return jm, tm, image, depth


@pytest.fixture(scope="module")
def outputs(slice_pair):
    jm, tm, image, depth = slice_pair
    want = jax_run_two_stage(jm, image, PROMPT, depth=depth,
                             trajectory_types=TRAJ, use_gs=True)
    got = run_two_stage(tm, image, PROMPT, depth=depth,
                        trajectory_types=TRAJ, use_gs=True)
    return want, got


def test_point_clouds_match_jax(outputs):
    want, got = outputs
    assert got["coords"].shape == (T, H * W, 3)
    assert np.abs(got["coords"].numpy() - want["coords"]).max() < 1e-4
    np.testing.assert_allclose(got["colors"].numpy(), want["colors"],
                               atol=1e-6)


def test_renders_and_masks_match_jax(outputs):
    """Given the same clouds the renders agree to 1e-5; end to end they
    agree to 1e-2 (see the module note on the splats' sensitivity)."""
    want, got = outputs
    assert [r["name"] for r in got["renders"]] == \
        [r["name"] for r in want["renders"]]
    same_cloud = render_trajectories(np.array(want["coords"]),
                                     np.array(want["colors"]), H, W, TRAJ)
    for g, s, w in zip(got["renders"], same_cloud, want["renders"]):
        np.testing.assert_array_equal(g["mask"].numpy(), w["mask"])
        np.testing.assert_array_equal(s["mask"].numpy(), w["mask"])
        assert np.abs(s["frames"].numpy() - w["frames"]).max() < 1e-5
        assert np.abs(g["frames"].numpy() - w["frames"]).max() < 1e-2


def test_inpainted_videos_match_jax(outputs):
    want, got = outputs
    assert len(got["videos"]) == len(want["videos"]) == 2
    for g, w in zip(got["videos"], want["videos"]):
        assert g["name"] == w["name"]
        video = g["video"].numpy()
        assert video.shape == (T, H, W, 3)
        assert np.isfinite(video).all()
        assert video.min() >= 0 and video.max() <= 1
        assert np.abs(video - np.asarray(w["video"])).max() < 1e-4


def test_batched_render_matches_serial(outputs):
    _, got = outputs
    kw = dict(trajectory_types=TRAJ + [("forward_backward", {})])
    batched = render_trajectories(got["coords"], got["colors"], H, W,
                                  batched=True, **kw)
    serial = render_trajectories(got["coords"], got["colors"], H, W,
                                 batched=False, **kw)
    for b, s in zip(batched, serial):
        assert b["name"] == s["name"]
        torch.testing.assert_close(b["frames"], s["frames"], rtol=0, atol=0)
        torch.testing.assert_close(b["mask"], s["mask"], rtol=0, atol=0)


def test_grouped_and_serial_stage2_match_batch(slice_pair, outputs):
    """The per-sample DiT and the shared initial noise make the serial
    sweep (``stage2_batch=1``), one render at a time (``stage2_inpaint``)
    and groups of two (``stage2_batch=2``) give the one-batch numbers, up
    to the CPU matmul's blocking, which changes with the batch (atol
    1e-4)."""
    _, tm, image, depth = slice_pair
    _, got = outputs
    whole = stage2_inpaint_batch(tm, got["renders"], PROMPT)
    serial = torch.stack([v["video"] for v in got["videos"]])
    torch.testing.assert_close(serial, whole, rtol=0, atol=1e-4)
    one = stage2_inpaint(tm, got["renders"][1], PROMPT)
    torch.testing.assert_close(one, whole[1], rtol=0, atol=1e-4)
    grouped = run_two_stage(tm, image, PROMPT, depth=depth,
                            trajectory_types=TRAJ, stage2_batch=2)
    torch.testing.assert_close(
        torch.stack([v["video"] for v in grouped["videos"]]), whole,
        rtol=0, atol=1e-4)


def test_cfg_skip_loop_matches_jax(slice_pair):
    """The two-phase loop: CFG-doubled steps, then cond-only steps."""
    jm, tm, _, _ = slice_pair
    rs = np.random.RandomState(9)
    lat = rs.randn(1, 2, 4, 4, 4).astype(np.float32)
    y = rs.randn(1, 2, 4, 4, 8).astype(np.float32)
    clip = rs.randn(1, 5, CLIP_DIM).astype(np.float32)
    ctx = rs.randn(1, 8, TEXT_DIM).astype(np.float32)
    neg = rs.randn(1, 8, TEXT_DIM).astype(np.float32)
    cfg = dict(num_inference_steps=4, guidance_scale=5.0, num_frames=T,
               height=H, width=W, cfg_skip_ratio=0.5)
    jp = JaxInpaint(jm.inpaint_pipeline.dit, jm.inpaint_pipeline.vae,
                    JaxPipelineConfig(**cfg))
    tp = WanInpaintPipeline(tm.inpaint_pipeline.dit,
                            tm.inpaint_pipeline.vae, PipelineConfig(**cfg),
                            "cpu")
    want = np.asarray(jp.denoise(jm.dit_inp_params, lat, ctx, neg, y=y,
                                 clip_fea=clip))
    got = tp.denoise(*map(torch.from_numpy, (lat, ctx, neg)),
                     y=torch.from_numpy(y), clip_fea=torch.from_numpy(clip))
    assert np.abs(got.numpy() - want).max() < 1e-4
    assert not np.allclose(got.numpy(), lat)


def test_models_are_data_classes():
    assert dataclasses.is_dataclass(TwoStageModels)
