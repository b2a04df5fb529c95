"""The slice with its towers: both packages' ``run_two_stage`` at the sizes
of ``test_torch_two_stage.py`` (32x32, 5 frames, tiny DiTs and VAE), with
tiny umT5, CLIP, OmniMAE and UniDepth towers on converted weights, one
stand-in tokenizer for both, ``depth=None`` (UniDepth estimates the depth)
and TeaCache on (the 1.3B coefficients at 0.10, one warm step) in both
stages.

Tolerances (fp32 on the CPU): the depth map max-abs 1e-5 x max(1, max
depth); point clouds atol 1e-4 at magnitude ~2 and inpainted videos (in
[0, 1]) atol 1e-4, as in ``test_torch_two_stage.py``; renders end to end
atol 1e-2 (see that file on the splats' sensitivity). Masks: at most 0.1%
of the pixels flip, where a point of the two clouds (7e-6 apart here) lies
on a pixel's edge; 2 of 5,120 pixels flip in one trajectory, and the
inpainted videos still agree to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.config import CLIPVisionConfig as JaxClipCfg
from more4d_tpu.config import PipelineConfig as JaxPipelineConfig
from more4d_tpu.config import T5Config as JaxT5Cfg
from more4d_tpu.config import VAEConfig as JaxVAEConfig
from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.infer import TwoStageModels as JaxTwoStageModels
from more4d_tpu.infer import run_two_stage as jax_run_two_stage
from more4d_tpu.models import WanDiT as JaxWanDiT
from more4d_tpu.models import clip as jclip
from more4d_tpu.models import omnimae as jomni
from more4d_tpu.models import t5 as jt5
from more4d_tpu.models import unidepth as jud
from more4d_tpu.models.adaptors import VAEDecoderAdaptor as JaxDecAdaptor
from more4d_tpu.models.wan_vae import WanVAE as JaxWanVAE
from more4d_tpu.pipelines import TeaCacheConfig as JaxTeaCacheConfig
from more4d_tpu.pipelines import WanControlPipeline as JaxControl
from more4d_tpu.pipelines import WanInpaintPipeline as JaxInpaint
from more4d_tpu_torch.config import (CLIPVisionConfig, PipelineConfig,
                                     T5Config, VAEConfig, dit_tiny)
from more4d_tpu_torch.convert import (adaptor_state_dict, dit_state_dict,
                                      vae_state_dict)
from more4d_tpu_torch.infer import (TwoStageModels, build_encoders,
                                    run_two_stage)
from more4d_tpu_torch.models import (ClipVisionTower, OmniMAEViT,
                                     UniDepthProvider, UniDepthV2,
                                     VAEDecoderAdaptor, WanDiT,
                                     WanT5Encoder, WanVAE)
from more4d_tpu_torch.pipelines import (TEACACHE_COEFFICIENTS,
                                        TeaCacheConfig, WanControlPipeline,
                                        WanInpaintPipeline)
from test_torch_two_stage import DIT4, DIT_INP, PROMPT, TRAJ, VAE, H, T, W
from test_torch_two_stage import _random_params

T5 = dict(vocab=64, dim=16, dim_attn=16, dim_ffn=32, num_heads=2,
          num_layers=2, num_buckets=8, text_len=8)
CLIP = dict(image_size=28, patch_size=14, dim=16, num_heads=2, num_layers=2)
OMNI = dict(embed_dim=8, depth=2, num_heads=2, image_size=32)
UD = dict(backbone_dim=16, backbone_depth=2, backbone_heads=2, hidden_dim=16,
          layer_ids=(0, 1))
BUDGET = 28 * 28                 # 32x32 -> 28x28, a 2x2 patch grid
TEACACHE = (tuple(TEACACHE_COEFFICIENTS["wan2.1-fun-1.3b"]), 0.10, 1)


def tokenize(prompts):
    """The stand-in tokenizer both packages use: a word's id is seeded by
    the word, then an end token; padded to text_len."""
    ids = np.zeros((len(prompts), T5["text_len"]), np.int64)
    mask = np.zeros(ids.shape, np.float32)
    for i, p in enumerate(prompts):
        words = [sum(map(ord, w)) % (T5["vocab"] - 2) + 2 for w in p.split()]
        row = (words + [1])[:T5["text_len"]]
        ids[i, :len(row)], mask[i, :len(row)] = row, 1
    return ids, mask


@pytest.fixture(scope="module")
def outputs():
    rs = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    # towers: the port's init_weights, carried to JAX by its converters
    t5 = WanT5Encoder(T5Config(dtype=torch.float32, **T5)).init_weights(gen)
    clip = ClipVisionTower(CLIPVisionConfig(dtype=torch.float32, **CLIP)
                           ).init_weights(gen)
    omni = OmniMAEViT(**OMNI).init_weights(gen)
    ud = UniDepthV2(**UD).init_weights(gen)
    jt5cfg = JaxT5Cfg(dtype=jnp.float32, **T5)
    jclipcfg = JaxClipCfg(dtype=jnp.float32, **CLIP)
    t5p = jt5.convert_t5_state_dict(t5.state_dict(), jt5cfg)
    clipp = jclip.convert_clip_vision_state_dict(
        {"visual." + k: v for k, v in clip.state_dict().items()}, jclipcfg)
    omnip = jomni.convert_omnimae_state_dict(omni.state_dict(), 2)
    udp = jud.convert_unidepth_state_dict(ud.state_dict(), num_adapters=2,
                                          backbone_depth=2)
    jt5m, jclipm = jt5.WanT5Encoder(jt5cfg), jclip.ClipVisionTower(jclipcfg)
    jomnim, judm = jomni.OmniMAEViT(**OMNI), jud.UniDepthV2(**UD)

    def j_encode_text(prompts):
        # the JAX build_text_encoder closure, with the stand-in tokenizer
        ids, mask = tokenize(prompts)
        return jt5m.apply(t5p, jnp.asarray(ids), jnp.asarray(mask)) * \
            jnp.asarray(mask)[..., None]

    # DiTs, VAE, adaptor: JAX params from numpy, carried to the port
    jvae = JaxWanVAE(JaxVAEConfig(**VAE))
    vae_p = _random_params(jvae.init, 1, 0.2, jnp.zeros((1, T, H, W, 3)))
    dit4 = dict(DIT4, text_dim=T5["dim"], clip_dim=CLIP["dim"],
                motion_feature_dim=OMNI["embed_dim"])
    dit_inp = dict(DIT_INP, text_dim=T5["dim"], clip_dim=CLIP["dim"])
    jcfg4 = jax_dit_tiny(dtype=jnp.float32, **dit4)
    jcfg_inp = jax_dit_tiny(dtype=jnp.float32, **dit_inp)
    tl, lh, lw = (T - 1) // 4 + 1, H // 8, W // 8
    lat = jnp.zeros((1, tl, lh, lw, 4))
    ctx = jnp.zeros((1, 8, T5["dim"]))
    clip0 = jnp.zeros((1, 5, CLIP["dim"]))
    p4 = _random_params(JaxWanDiT(jcfg4).init, 4, 0.03, lat,
                        jnp.zeros((1,)), ctx,
                        y=jnp.zeros((1, tl, lh, lw, 12)), clip_fea=clip0,
                        mpm_features=jnp.zeros((1, 4, OMNI["embed_dim"])))
    p_inp = _random_params(JaxWanDiT(jcfg_inp).init, 5, 0.03, lat,
                           jnp.zeros((1,)), ctx,
                           y=jnp.zeros((1, tl, lh, lw, 8)), clip_fea=clip0)
    jdec = JaxDecAdaptor(ch=8)
    dec_p = _random_params(jdec.init, 6, 0.1, jnp.zeros((1, T, H, W, 3)))
    noise1 = rs.randn(1, tl, lh, lw, 4).astype(np.float32)
    noise2 = rs.randn(1, tl, lh, lw, 4).astype(np.float32)
    image = rs.rand(H, W, 3).astype(np.float32)

    pcfg = dict(num_inference_steps=3, guidance_scale=5.0, num_frames=T,
                height=H, width=W)
    jtc = JaxTeaCacheConfig(*TEACACHE)
    jctrl = JaxControl(JaxWanDiT(jcfg4), jvae, JaxPipelineConfig(**pcfg),
                       teacache=jtc)
    jinp = JaxInpaint(JaxWanDiT(jcfg_inp), jvae, JaxPipelineConfig(**pcfg),
                      teacache=jtc)
    jctrl.prepare_latents = lambda rng, b, *a, **k: jnp.asarray(noise1[:b])
    jinp.prepare_latents = lambda rng, b, *a, **k: jnp.asarray(noise2[:b])
    jm = JaxTwoStageModels(
        control_pipeline=jctrl, inpaint_pipeline=jinp, dit4d_params=p4,
        dit_inp_params=p_inp, vae_params=vae_p, decoder_adaptor=jdec,
        decoder_adaptor_params=dec_p, encode_text=j_encode_text,
        encode_image_clip=lambda im: jclip.encode_image(jclipm, clipp, im),
        extract_mpm=lambda im: jomni.extract_mpm_features(jomnim, omnip,
                                                          im)[0],
        estimate_depth=jud.JaxUniDepthProvider(params=udp, model=judm,
                                               pixel_budget=BUDGET))

    tcfg4 = dit_tiny(dtype=torch.float32, **dit4)
    tcfg_inp = dit_tiny(dtype=torch.float32, **dit_inp)
    tdit4, tdit_inp = WanDiT(tcfg4), WanDiT(tcfg_inp)
    tdit4.load_state_dict(dit_state_dict(p4, tcfg4), strict=True)
    tdit_inp.load_state_dict(dit_state_dict(p_inp, tcfg_inp), strict=True)
    vae = WanVAE(VAEConfig(**VAE))
    vae.load_state_dict(vae_state_dict(vae_p, vae.cfg), strict=True)
    dec = VAEDecoderAdaptor(ch=8)
    dec.load_state_dict(adaptor_state_dict(dec_p, decoder=True), strict=True)
    tc = TeaCacheConfig(*TEACACHE)
    tctrl = WanControlPipeline(tdit4, vae, PipelineConfig(**pcfg), "cpu",
                               teacache=tc)
    tinp = WanInpaintPipeline(tdit_inp, vae, PipelineConfig(**pcfg), "cpu",
                              teacache=tc)
    tctrl.prepare_latents = lambda g, b, *a, **k: torch.from_numpy(
        noise1[:b])
    tinp.prepare_latents = lambda g, b, *a, **k: torch.from_numpy(
        noise2[:b])
    enc = build_encoders(t5=t5, tokenize=tokenize, clip=clip, omnimae=omni,
                         device="cpu")
    depth = UniDepthProvider(model=ud, pixel_budget=BUDGET, device="cpu")
    tm = TwoStageModels(
        control_pipeline=tctrl, inpaint_pipeline=tinp, decoder_adaptor=dec,
        encode_text=enc.encode_text, encode_image_clip=enc.encode_clip,
        extract_mpm=enc.extract_mpm, estimate_depth=depth)

    want = jax_run_two_stage(jm, image, PROMPT, trajectory_types=TRAJ)
    got = run_two_stage(tm, image, PROMPT, trajectory_types=TRAJ)
    return dict(want=want, got=got, depth=(depth(image),
                                           jm.estimate_depth(image)),
                decisions=[calc for _, _, calc in tctrl.teacache_state.log])


def test_estimated_depth_matches_jax(outputs):
    got, want = outputs["depth"]
    assert got.shape == (H, W) and (got > 0).all()
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert np.abs(got.numpy() - want).max() <= tol


def test_point_clouds_match_jax(outputs):
    want, got = outputs["want"], outputs["got"]
    assert got["coords"].shape == (T, H * W, 3)
    assert np.abs(got["coords"].numpy() - want["coords"]).max() < 1e-4


def test_renders_and_videos_match_jax(outputs):
    want, got = outputs["want"], outputs["got"]
    # TeaCache replayed: stage 1 ran its block stack only on its warm step
    assert outputs["decisions"] == [True, False, False]
    for g, w in zip(got["renders"], want["renders"]):
        flips = (g["mask"].numpy() != w["mask"]).mean()
        assert flips <= 1e-3
        assert np.abs(g["frames"].numpy() - w["frames"]).max() < 1e-2
    assert len(got["videos"]) == len(want["videos"]) == 2
    for g, w in zip(got["videos"], want["videos"]):
        video = g["video"].numpy()
        assert video.shape == (T, H, W, 3) and np.isfinite(video).all()
        assert np.abs(video - np.asarray(w["video"])).max() < 1e-4
