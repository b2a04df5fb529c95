"""The port's TeaCache against the JAX pipelines' on the CPU (tiny i2v InP
DiT, fp32).

JAX decides inside ``lax.cond``; its calc/replay sequence is read by
running the same loop under ``jax.disable_jit()`` (the loop and the cond
then run as Python, the same numbers to 5e-7) with the JAX ``WanDiT``'s
``embed`` and ``backbone`` wrapped to mark each step and each block-stack
run. Latents: atol 1e-4 (the tolerance of ``test_torch_two_stage.py``'s
cfg-skip loop; both sides order their sums differently). The residual
offload is held to the resident residual bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.config import PipelineConfig as JaxPipelineConfig
from more4d_tpu.config import VAEConfig as JaxVAEConfig
from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.models import WanDiT as JaxWanDiT
from more4d_tpu.models.wan_vae import WanVAE as JaxWanVAE
from more4d_tpu.pipelines import TeaCacheConfig as JaxTeaCacheConfig
from more4d_tpu.pipelines import WanInpaintPipeline as JaxInpaint
from more4d_tpu_torch.config import PipelineConfig, VAEConfig, dit_tiny
from more4d_tpu_torch.convert import dit_state_dict
from more4d_tpu_torch.models import WanDiT, WanVAE
from more4d_tpu_torch.models import wan_dit as port_wan_dit
from more4d_tpu_torch.pipelines import (TEACACHE_COEFFICIENTS,
                                        TeaCacheConfig, TeaCacheState,
                                        WanInpaintPipeline)

DIT = dict(in_dim=12, out_dim=4, dim=32, ffn_dim=64, num_heads=2,
           num_layers=2, text_dim=16, clip_dim=16, text_len=8, clip_tokens=5,
           model_type="i2v")
VAE = dict(dim=4, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
           temporal_downsample=(False, True, True))
# 8 steps, the last 4 cond-only: the cfg-skip transition after step 3
PCFG = dict(num_inference_steps=8, guidance_scale=5.0, cfg_skip_ratio=0.5,
            num_frames=5, height=32, width=32)
LINEAR = (0.0, 0.0, 0.0, 1.0, 0.0)          # poly(rel) = rel


@pytest.fixture(scope="module")
def setup():
    rs = np.random.RandomState(0)
    jcfg = jax_dit_tiny(dtype=jnp.float32, **DIT)
    jdit = JaxWanDiT(jcfg)
    inputs = dict(lat=rs.randn(1, 2, 4, 4, 4), y=rs.randn(1, 2, 4, 4, 8),
                  ctx=rs.randn(1, 8, 16), neg=rs.randn(1, 8, 16),
                  clip=rs.randn(1, 5, 16))
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    shapes = jax.eval_shape(jdit.init, jax.random.PRNGKey(0),
                            jnp.asarray(inputs["lat"]), jnp.zeros((1,)),
                            jnp.asarray(inputs["ctx"]),
                            y=jnp.asarray(inputs["y"]),
                            clip_fea=jnp.asarray(inputs["clip"]))
    leaves, td = jax.tree_util.tree_flatten(shapes)
    params = jax.tree_util.tree_unflatten(
        td, [np.asarray(rs.normal(0, 0.05, l.shape), np.float32)
             for l in leaves])
    tcfg = dit_tiny(dtype=torch.float32, **DIT)
    dit = WanDiT(tcfg)
    dit.load_state_dict(dit_state_dict(params, tcfg), strict=True)
    return jdit, params, dit, WanVAE(VAEConfig(**VAE)), inputs


def jax_denoise(setup, teacache):
    """(latents, calc/replay sequence) of the JAX loop."""
    jdit, params, _, _, x = setup
    pipe = JaxInpaint(jdit, JaxWanVAE(JaxVAEConfig(**VAE)),
                      JaxPipelineConfig(**PCFG), teacache=teacache)
    calls = []
    embed, backbone = JaxWanDiT.embed, JaxWanDiT.backbone

    def marked_embed(self, *a, **k):
        calls.append(False)
        return embed(self, *a, **k)

    def marked_backbone(self, *a, **k):
        calls[-1] = True
        return backbone(self, *a, **k)

    JaxWanDiT.embed, JaxWanDiT.backbone = marked_embed, marked_backbone
    try:
        with jax.disable_jit():
            out = pipe.denoise(params, x["lat"], x["ctx"], x["neg"],
                               y=x["y"], clip_fea=x["clip"])
    finally:
        JaxWanDiT.embed, JaxWanDiT.backbone = embed, backbone
    return np.asarray(out), calls


def port_pipe(setup, teacache):
    _, _, dit, vae, _ = setup
    return WanInpaintPipeline(dit, vae, PipelineConfig(**PCFG), "cpu",
                              teacache=teacache)


def port_denoise(pipe, setup):
    x = setup[-1]
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    return pipe.denoise(t["lat"], t["ctx"], t["neg"], y=t["y"],
                        clip_fea=t["clip"])


@pytest.mark.parametrize("coefficients,thresh,warm", [
    (LINEAR, 0.6, 1),
    (tuple(TEACACHE_COEFFICIENTS["wan2.1-fun-1.3b"]), 0.10, 2),
], ids=["linear_0.6", "wan2.1-fun-1.3b_0.10"])
def test_decisions_and_latents_match_jax(setup, coefficients, thresh, warm):
    """The rescale polynomial of the 1.3B backbone gives a negative
    accumulation on this random model, so every step past the warm-up
    replays; the linear one at 0.6 mixes calc and replay on both sides of
    the cfg-skip transition."""
    want, want_calls = jax_denoise(setup, JaxTeaCacheConfig(
        coefficients, thresh, warm))
    pipe = port_pipe(setup, TeaCacheConfig(coefficients, thresh, warm))
    got = port_denoise(pipe, setup)
    calls = [calc for _, _, calc in pipe.teacache_state.log]
    assert calls == want_calls
    assert not all(calls) and any(calls[warm:]) == (thresh == 0.6)
    assert np.abs(got.numpy() - want).max() < 1e-4


def test_threshold_zero_is_bit_identical_to_no_teacache(setup):
    """With poly(rel) = rel and threshold 0 every step computes, so the
    latents are the loop's without TeaCache, bit for bit."""
    plain = port_denoise(port_pipe(setup, None), setup)
    pipe = port_pipe(setup, TeaCacheConfig(LINEAR, 0.0, 0))
    cached = port_denoise(pipe, setup)
    assert all(calc for _, _, calc in pipe.teacache_state.log)
    assert torch.equal(plain, cached)


def test_replay_step_runs_no_attention(setup, monkeypatch):
    """A calc step runs the block stack (3 attentions a block: self, text,
    CLIP); a replay step runs none, which on the card is no K1 launch."""
    pipe = port_pipe(setup, TeaCacheConfig(LINEAR, 0.6, 1))
    per_step, attention = [], port_wan_dit.attention

    def counted(*a, **k):
        per_step[-1] += 1
        return attention(*a, **k)

    step = pipe._step

    def marked_step(*a, **k):
        per_step.append(0)
        return step(*a, **k)

    monkeypatch.setattr(port_wan_dit, "attention", counted)
    monkeypatch.setattr(pipe, "_step", marked_step)
    port_denoise(pipe, setup)
    calls = [calc for _, _, calc in pipe.teacache_state.log]
    assert per_step == [6 if calc else 0 for calc in calls]
    assert 0 in per_step and 6 in per_step


@pytest.mark.parametrize("coefficients,thresh,warm", [
    (LINEAR, 0.6, 1), (LINEAR, 0.0, 0)], ids=["linear_0.6", "linear_0"])
def test_residual_offload_is_bit_identical_and_matches_jax(
        setup, coefficients, thresh, warm):
    """``offload_residual`` keeps the residual in host memory between
    steps (a copy of its own, pinned on the card): the latents are the
    resident residual's bit for bit, and JAX's offloaded loop's to 1e-4
    with its calc/replay sequence."""
    resident = port_denoise(port_pipe(setup, TeaCacheConfig(
        coefficients, thresh, warm)), setup)
    pipe = port_pipe(setup, TeaCacheConfig(coefficients, thresh, warm,
                                           offload_residual=True))
    stored = []
    store = TeaCacheState.store

    def spy(self, r):
        store(self, r)
        stored.append(self.residual is not r and torch.equal(self.residual, r)
                      and self.residual.device.type == "cpu")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TeaCacheState, "store", spy)
        got = port_denoise(pipe, setup)
    assert torch.equal(got, resident)
    assert stored and all(stored)
    want, want_calls = jax_denoise(setup, JaxTeaCacheConfig(
        coefficients, thresh, warm, offload_residual=True))
    assert [c for _, _, c in pipe.teacache_state.log] == want_calls
    assert np.abs(got.numpy() - want).max() < 1e-4
