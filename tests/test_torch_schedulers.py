"""The port's DPM++ and UniPC samplers against the JAX package's on the CPU.

Both samplers run the settings ``tests/test_schedulers_golden.py`` holds
against the reference (the defaults at 10 and 50 steps, every knob, the
sde variants with the same noise injected), each on its own trajectory
from the same numpy x0 under the same synthetic model (v = 0.3 x +
sin(t)): every step's sample within 1e-5 relative (max-abs over the
largest |x|). Then the denoise loop with ``flow_dpm++``, with and without
cfg-skip, against the JAX pipeline's on the same noise (the tolerance of
``test_torch_pipelines_teacache.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu import diffusion as jd
from more4d_tpu.config import PipelineConfig as JaxPipelineConfig
from more4d_tpu.config import VAEConfig as JaxVAEConfig
from more4d_tpu.models.wan_vae import WanVAE as JaxWanVAE
from more4d_tpu.pipelines import WanInpaintPipeline as JaxInpaint
from more4d_tpu_torch import diffusion as td
from more4d_tpu_torch.config import PipelineConfig
from more4d_tpu_torch.pipelines import WanInpaintPipeline
from test_torch_pipelines_teacache import PCFG, VAE, setup  # noqa: F401

SHAPE = (1, 4, 3, 2, 2)
REL_TOL = 1e-5


def velocity(x, t):
    return 0.3 * x + np.sin(t / 1000.0 * np.pi)


def trajectories(jsched, tsched, x0, steps, noises=None):
    """Each sampler's samples after every step, from x0."""
    xj, xt = jnp.asarray(x0), torch.from_numpy(x0.copy())
    sj, st = jsched.init_state(SHAPE), tsched.init_state(SHAPE)
    out = []
    for i in range(steps):
        t = float(jsched.timesteps[i])
        assert t == float(tsched.timesteps[i])
        kw_j, kw_t = {}, {}
        if noises is not None:
            kw_j["noise"] = jnp.asarray(noises[i])
            kw_t["noise"] = torch.from_numpy(noises[i])
        vj = jnp.asarray(velocity(np.asarray(xj), t).astype(np.float32))
        vt = torch.from_numpy(velocity(xt.numpy(), t).astype(np.float32))
        xj, sj = jsched.step(i, xj, vj, sj, **kw_j)
        xt, st = tsched.step(i, xt, vt, st, **kw_t)
        out.append((np.asarray(xj), xt.numpy()))
    return out


def assert_close(traj):
    for i, (want, got) in enumerate(traj):
        assert np.isfinite(got).all(), i
        rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
        assert rel <= REL_TOL, (i, rel)


def knob_sigmas(steps, shift, scale):
    return (td.sampling_sigmas(steps, shift) * scale).astype(np.float32)


def test_sigmas_are_jax_sigmas():
    for n, shift in ((10, 3.0), (50, 5.0), (12, 3.0)):
        np.testing.assert_array_equal(td.sampling_sigmas(n, shift),
                                      jd.sampling_sigmas(n, shift))


@pytest.mark.parametrize("kind", ["dpm", "unipc"])
@pytest.mark.parametrize("steps,shift", [(10, 3.0), (50, 5.0)])
def test_defaults_match_jax(kind, steps, shift):
    x0 = np.random.RandomState(0 if kind == "dpm" else 1).randn(
        *SHAPE).astype(np.float32)
    name = "flow_dpm++" if kind == "dpm" else "flow_unipc"
    jsched = jd.get_scheduler(name, steps, shift)
    tsched = td.get_scheduler(name, steps, shift)
    assert type(tsched).__name__ == type(jsched).__name__
    assert_close(trajectories(jsched, tsched, x0, steps))


DPM_KNOBS = [
    (dict(solver_order=1), 1.0, False),
    (dict(solver_order=3), 1.0, False),
    (dict(solver_order=2, solver_type="heun"), 1.0, False),
    (dict(solver_order=3, solver_type="heun"), 1.0, False),
    (dict(solver_order=2, algorithm_type="dpmsolver"), 0.9, True),
    (dict(solver_order=3, algorithm_type="dpmsolver"), 0.9, True),
    (dict(solver_order=2, thresholding=True, dynamic_thresholding_ratio=0.9,
          sample_max_value=1.5), 1.0, False),
    (dict(solver_order=2, euler_at_final=True), 1.0, False),
    (dict(solver_order=2, lower_order_final=False), 1.0, True),
]


@pytest.mark.parametrize("kw,scale,skip_last", DPM_KNOBS)
def test_dpm_knobs_match_jax(kw, scale, skip_last):
    steps = 12
    x0 = np.random.RandomState(3).randn(*SHAPE).astype(np.float32)
    sig = knob_sigmas(steps, 3.0, scale)
    assert_close(trajectories(jd.FlowDPMScheduler(sigmas=sig, **kw),
                              td.FlowDPMScheduler(sigmas=sig, **kw), x0,
                              steps - skip_last))


@pytest.mark.parametrize("kw,scale,skip_last", [
    (dict(solver_order=2, algorithm_type="sde-dpmsolver++"), 1.0, False),
    (dict(solver_order=1, algorithm_type="sde-dpmsolver"), 0.9, True),
    (dict(solver_order=2, algorithm_type="sde-dpmsolver"), 0.9, True),
])
def test_dpm_sde_with_injected_noise_matches_jax(kw, scale, skip_last):
    steps = 10
    x0 = np.random.RandomState(4).randn(*SHAPE).astype(np.float32)
    noises = np.random.RandomState(5).randn(steps, *SHAPE).astype(np.float32)
    sig = knob_sigmas(steps, 3.0, scale)
    assert_close(trajectories(jd.FlowDPMScheduler(sigmas=sig, **kw),
                              td.FlowDPMScheduler(sigmas=sig, **kw), x0,
                              steps - skip_last, noises))


def test_dpm_sde_draws_from_its_seed():
    """Without injected noise an sde step draws from the generator that
    ``init_state`` seeds with ``sde_seed``: the same seed repeats, another
    differs."""
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))

    def run(seed):
        s = td.FlowDPMScheduler.create(6, 3.0, algorithm_type=(
            "sde-dpmsolver++"), sde_seed=seed)
        state, xi = s.init_state(SHAPE), x
        for i in range(s.num_steps):
            xi, state = s.step(i, xi, 0.3 * xi, state)
        return xi

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


UNIPC_KNOBS = [
    (dict(solver_order=1), 1.0, False),
    (dict(solver_order=3), 0.9, False),
    (dict(solver_order=2, solver_type="bh1"), 0.9, True),
    (dict(solver_order=3, solver_type="bh1"), 0.9, True),
    # predict_x0=False divides by alpha = 1 - sigma: at sigma_0 = 1 both
    # packages step to +-inf, so the schedule is scaled
    (dict(solver_order=2, predict_x0=False), 0.9, False),
    (dict(solver_order=3, predict_x0=False), 0.9, True),
    (dict(solver_order=2, thresholding=True, dynamic_thresholding_ratio=0.9,
          sample_max_value=1.5), 1.0, False),
    (dict(solver_order=2, disable_corrector=(0, 3, 7)), 1.0, False),
    (dict(solver_order=2, lower_order_final=False), 1.0, True),
]


@pytest.mark.parametrize("kw,scale,skip_last", UNIPC_KNOBS)
def test_unipc_knobs_match_jax(kw, scale, skip_last):
    steps = 12
    x0 = np.random.RandomState(6).randn(*SHAPE).astype(np.float32)
    sig = knob_sigmas(steps, 3.0, scale)
    assert_close(trajectories(jd.FlowUniPCScheduler(sigmas=sig, **kw),
                              td.FlowUniPCScheduler(sigmas=sig, **kw), x0,
                              steps - skip_last))


def test_get_scheduler_knobs_and_refusals():
    s = td.get_scheduler("flow_dpm++", 4, 3.0, solver_order=3,
                         solver_type="heun")
    assert isinstance(s, td.FlowDPMScheduler) and s.solver_order == 3
    assert isinstance(td.get_scheduler("flow_unipc", 4, 3.0,
                                       solver_type="bh1"),
                      td.FlowUniPCScheduler)
    with pytest.raises(ValueError):
        td.get_scheduler("flow", 4, 3.0, solver_order=2)
    with pytest.raises(ValueError):
        td.FlowDPMScheduler.create(4, 3.0, solver_order=3,
                                   algorithm_type="sde-dpmsolver++")
    with pytest.raises(ValueError):
        td.get_scheduler("ddim", 4, 3.0)


@pytest.mark.parametrize("cfg_skip_ratio", [0.0, 0.5])
def test_denoise_with_dpm_matches_jax(setup, cfg_skip_ratio):  # noqa: F811
    """The whole loop: the sampler state carried across the CFG-doubled
    steps and, with cfg-skip, into the cond-only tail."""
    jdit, params, dit, vae, x = setup
    pcfg = dict(PCFG, cfg_skip_ratio=cfg_skip_ratio, scheduler="flow_dpm++",
                scheduler_kwargs=(("solver_order", 2),))
    want = JaxInpaint(jdit, JaxWanVAE(JaxVAEConfig(**VAE)),
                      JaxPipelineConfig(**pcfg)).denoise(
        params, x["lat"], x["ctx"], x["neg"], y=x["y"], clip_fea=x["clip"])
    pipe = WanInpaintPipeline(dit, vae, PipelineConfig(**pcfg), "cpu")
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    got = pipe.denoise(t["lat"], t["ctx"], t["neg"], y=t["y"],
                       clip_fea=t["clip"])
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-4
    # a stateless sampler in the same loop gives another answer: the state
    # is what carries the multistep history
    euler = WanInpaintPipeline(dit, vae, PipelineConfig(
        **dataclasses.replace(PipelineConfig(**pcfg), scheduler="flow",
                              scheduler_kwargs=()).__dict__), "cpu")
    assert not torch.allclose(euler.denoise(
        t["lat"], t["ctx"], t["neg"], y=t["y"], clip_fea=t["clip"]), got,
        atol=1e-3)
