"""The port's 4D-STraG train step against the JAX ``make_train_step``, on
the CPU in fp32, at a tiny 4D-STraG DiT (motion guidance, i2v) with the
same converted weights and JAX's own timestep and noise draws handed to
the port's step.

Params are random normal, not the zero-initialised gates and head of a
fresh model: those would give near-zero gradients, and AdamW's
m_hat / sqrt(v_hat) turns the sign noise of a near-zero gradient into an
update the size of the learning rate.

Tolerances (fp32; the two sides sum in other orders): loss rtol 1e-5;
grad norm rtol 1e-5; every gradient atol 1e-6 at magnitudes up to 0.1
(measured: 9e-8 at most, in the time embedding, whose sin/cos of
arguments up to 1000 differ in their last bits between the two
libraries); params and EMA after each step atol 1e-5, 1% of a step at lr
1e-3: AdamW divides each gradient by its own running magnitude, so a
gradient a few times larger than its last-bit difference moves its
update by more than its share (measured: 1.04e-6, one element of the
time embedding). Remat on and off give identical gradients (same ops,
same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.models import WanDiT as JaxWanDiT
from more4d_tpu.train.optim import custom_mse_loss as jax_mse
from more4d_tpu.train.optim import make_adamw as jax_make_adamw
from more4d_tpu.train.optim import make_lr_schedule as jax_make_lr_schedule
from more4d_tpu.train.sampler import StratifiedTimestepSampler
from more4d_tpu.train.train_straag import StraagTrainConfig as JaxCfg
from more4d_tpu.train.train_straag import make_train_step
from more4d_tpu.train.train_straag import \
    training_schedule as jax_training_schedule
from more4d_tpu_torch.config import dit_tiny
from more4d_tpu_torch.convert import dit_state_dict
from more4d_tpu_torch.models import WanDiT
from more4d_tpu_torch.train import (StraagTrainConfig, draw, make_adamw,
                                    make_lr_schedule, should_skip_update,
                                    train_step, training_schedule)
from more4d_tpu_torch.train.optim import dynamic_clip_norm, global_grad_norm
from more4d_tpu_torch.train.train_straag import straag_loss

DIT = dict(in_dim=16, out_dim=4, dim=32, ffn_dim=64, num_heads=2,
           num_layers=2, text_dim=16, clip_dim=16, text_len=8,
           motion_guidance=True, model_type="i2v")
B, LT, LH, LW = 2, 2, 4, 4
GRAD_ATOL = 1e-6
PARAM_ATOL = 1e-5


def _batch(cfg, seed=0):
    rs = np.random.RandomState(seed)
    return {"latents": rs.randn(B, LT, LH, LW, 4).astype(np.float32),
            "y": rs.randn(B, LT, LH, LW, 12).astype(np.float32),
            "context": rs.randn(B, 8, 16).astype(np.float32),
            "clip_fea": rs.randn(B, cfg.clip_tokens, 16).astype(np.float32),
            "mpm_features": rs.randn(B, 196, cfg.motion_feature_dim
                                     ).astype(np.float32)}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_dit_tiny(dtype=jnp.float32, **DIT)
    jdit = JaxWanDiT(jcfg)
    batch = _batch(jcfg)
    shapes = jax.eval_shape(
        jdit.init, jax.random.PRNGKey(0), batch["latents"],
        jnp.zeros((B,)), batch["context"], y=batch["y"],
        clip_fea=batch["clip_fea"], mpm_features=batch["mpm_features"])
    leaves, td = jax.tree_util.tree_flatten(shapes)
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_unflatten(
        td, [jnp.asarray(rs.normal(0, 0.04, l.shape), jnp.float32)
             for l in leaves])
    return jcfg, jdit, params, batch


def _port_dit(jcfg, params, **over):
    cfg = dit_tiny(dtype=torch.float32, **dict(DIT, **over))
    dit = WanDiT(cfg)
    dit.load_state_dict(dit_state_dict(params, cfg), strict=True)
    return dit


def _jax_draws(key, cfg, shape):
    """make_train_step's own draws for one step."""
    rng_t, rng_n = jax.random.split(key)
    idx = StratifiedTimestepSampler(cfg.num_train_timesteps,
                                    uniform_sampling=cfg.uniform_sampling,
                                    world_size=cfg.world_size)(rng_t,
                                                               shape[0])
    noise = jax.random.normal(rng_n, shape, jnp.float32)
    return (torch.from_numpy(np.asarray(idx).astype(np.int64)),
            torch.from_numpy(np.array(noise)))


def _assert_tree_close(sd, tree, jcfg, what, atol=GRAD_ATOL):
    want = dit_state_dict(tree, _torch_cfg(jcfg))
    assert set(sd) == set(want)
    for name, w in want.items():
        err = (sd[name].detach().float() - w).abs().max().item()
        assert err < atol, f"{what} {name}: {err}"


def _torch_cfg(jcfg):
    return dit_tiny(dtype=torch.float32, **DIT)


def _run_both(models, jcfg_train, tcfg_train, jax_tx, make_torch_opt,
              steps=3, trainable=None):
    """Run ``steps`` steps of both trainers from the same params; yield
    each step's (jax metrics, port metrics, jax params, jax ema, port
    params, port ema), the port's as copies."""
    jcfg, jdit, params, batch = models
    step = jax.jit(make_train_step(jdit, jax_tx, jcfg_train,
                                   trainable_filter=trainable))
    opt_state = jax_tx.init(params)
    jp, jema = params, jax.tree_util.tree_map(jnp.copy, params)
    dit = _port_dit(jcfg, params)
    if trainable is not None:
        for name, p in dit.named_parameters():
            p.requires_grad_(trainable(name))
    opt, sched = make_torch_opt(
        [p for p in dit.parameters() if p.requires_grad])
    ema = {n: p.detach().clone() for n, p in dit.named_parameters()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(3)
    for i in range(steps):
        key, sub = jax.random.split(key)
        idx, noise = _jax_draws(sub, jcfg_train, batch["latents"].shape)
        jp, opt_state, jema, jm = step(jp, opt_state, jema, batch, sub, i)
        tm = train_step(dit, opt, ema, tcfg_train, tbatch, idx, noise, i,
                        sched)
        yield (jm, tm, jp, jema,
               {n: p.detach().clone() for n, p in dit.state_dict().items()},
               {n: e.clone() for n, e in ema.items()})


def _check_step(jm, tm, jp, jema, params, ema, jcfg):
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                               rtol=1e-5)
    assert tm["skipped"] == bool(jm["skipped"])
    _assert_tree_close(params, jp, jcfg, "params", PARAM_ATOL)
    _assert_tree_close(ema, jema, jcfg, "ema", PARAM_ATOL)


def test_gradients_match_jax(models):
    """Every parameter's gradient of the flow-matching loss, before the
    clamp, against jax.grad of make_train_step's loss on JAX's draws."""
    jcfg, jdit, params, batch = models
    cfg = JaxCfg()
    idx, noise = _jax_draws(jax.random.PRNGKey(7), cfg,
                            batch["latents"].shape)
    sig = jnp.asarray(jax_training_schedule())[jnp.asarray(idx.numpy())]
    x = jnp.asarray(batch["latents"])
    s5 = sig.reshape(B, 1, 1, 1, 1)
    zt = (1 - s5) * x + s5 * jnp.asarray(noise.numpy())

    def loss_fn(p):
        pred = jdit.apply(p, zt, sig * 1000.0, batch["context"],
                          y=batch["y"], clip_fea=batch["clip_fea"],
                          mpm_features=batch["mpm_features"])
        return jax_mse(pred, jnp.asarray(noise.numpy()) - x,
                       weighting=jnp.ones_like(s5))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    dit = _port_dit(jcfg, params)
    loss = straag_loss(dit, StraagTrainConfig(),
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       idx, noise)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close({n: p.grad for n, p in dit.named_parameters()},
                       jgrads, jcfg, "grad")
    np.testing.assert_allclose(
        float(global_grad_norm(p.grad for p in dit.parameters())),
        float(optax.global_norm(jgrads)), rtol=1e-5)


def test_three_steps_with_a_skip_match_jax(models):
    """AdamW at the harness default (optax.adamw(lr): eps 1e-8, weight
    decay 1e-4), EMA, and the abnormal-loss guard: steps 0 and 1 apply,
    step 2 (past abnormal_loss_start_step=1, loss above the threshold)
    skips and keeps params, optimizer state and EMA."""
    jcfg = models[0]
    kw = dict(learning_rate=1e-3, abnormal_loss_start_step=1,
              abnormal_loss_threshold=1e-6, ema_decay=0.9)
    steps = list(_run_both(
        models, JaxCfg(**kw), StraagTrainConfig(**kw), optax.adamw(1e-3),
        lambda ps: (torch.optim.AdamW(ps, lr=1e-3, eps=1e-8,
                                      weight_decay=1e-4), None)))
    assert [s[1]["skipped"] for s in steps] == [False, False, True]
    for step in steps:
        _check_step(*step, jcfg)


def test_warmup_schedule_and_trainable_filter_match_jax(models):
    """The shipped AdamW (betas (0.9, 0.999), weight decay 3e-2, eps
    1e-10) under constant_with_warmup over 2 steps (lr 0, lr/2, lr: the
    first step's lr is 0 in both), with only the self-attention and the
    head trainable: frozen params get no update and no decay."""
    jcfg, _, params, _ = models
    kw = dict(learning_rate=1e-3, abnormal_loss_threshold=1e9)

    def trainable(path):
        return "self_attn" in path or "head" in path

    steps = list(_run_both(
        models, JaxCfg(**kw), StraagTrainConfig(**kw),
        jax_make_adamw(jax_make_lr_schedule(1e-3, "constant_with_warmup",
                                            2)),
        lambda ps: make_adamw(ps, make_lr_schedule(
            1e-3, "constant_with_warmup", 2)), trainable=trainable))
    start = _port_dit(jcfg, params).state_dict()
    for i, step in enumerate(steps):
        _check_step(*step, jcfg)
        for name, p in step[4].items():
            moved = not torch.equal(p, start[name])
            assert moved == (i > 0 and trainable(name)), name


def test_remat_gives_identical_gradients(models):
    jcfg, _, params, batch = models
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    idx, noise = draw(StraagTrainConfig(), tb, gen)
    grads = []
    for remat in (False, True):
        dit = _port_dit(jcfg, params, remat=remat)
        assert bool(dit.remat_blocks()) == remat
        straag_loss(dit, StraagTrainConfig(), tb, idx, noise).backward()
        grads.append({n: p.grad for n, p in dit.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0)


def test_remat_fraction_and_unported_policies(models):
    jcfg, _, params, _ = models
    dit = _port_dit(jcfg, params, remat=True, num_layers=2,
                    remat_fraction=0.5)
    assert dit.remat_blocks() == {0}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_dit(jcfg, params, remat=True,
                  remat_policy="flash").remat_blocks()


def test_schedule_skip_rule_and_clip_match_jax():
    np.testing.assert_array_equal(training_schedule(),
                                  jax_training_schedule())
    cfg = StraagTrainConfig(abnormal_loss_start_step=5)
    assert should_skip_update(float("nan"), 0, cfg)
    assert not should_skip_update(1.0, 5, cfg)
    assert should_skip_update(1.0, 6, cfg)
    for name in ("constant_with_warmup", "linear", "cosine"):
        ours = make_lr_schedule(1e-3, name, 3, 10)
        theirs = jax_make_lr_schedule(1e-3, name, 3, 10)
        for n in range(12):
            np.testing.assert_allclose(ours(n), float(theirs(n)), rtol=1e-6,
                                       atol=1e-12)
    g = [torch.ones(10) * 100.0]
    norm, used = dynamic_clip_norm(g, 2000, 0.05, decay_steps=1000)
    np.testing.assert_allclose(float(g[0].norm()), float(used), rtol=1e-6)
    assert float(used) < 0.05 and float(norm) > 300


@pytest.mark.parametrize("scheme", ["none", "sigma_sqrt", "cosmap",
                                    "logit_normal", "mode"])
def test_sd3_sampling_and_weighting_match_jax(scheme):
    """loss_weighting_sd3 on the same sigmas equals JAX's (rtol 1e-6,
    fp32); timestep_density_u draws from the same distribution (the two
    generators differ, so the sorted samples of the 'mode' warp and the
    logit-normal moments are compared: atol 5e-3 at 50,000 draws, ~3 x
    their standard error); ``draw`` gives in-range indices either way."""
    from more4d_tpu.train.sampler import loss_weighting_sd3 as jax_weight
    from more4d_tpu.train.sampler import timestep_density_u as jax_density
    from more4d_tpu_torch.train import loss_weighting_sd3, timestep_density_u

    sig = np.random.RandomState(0).uniform(1e-3, 1.0, (16,)).astype(
        np.float32)
    np.testing.assert_allclose(loss_weighting_sd3(scheme, sig).numpy(),
                               np.asarray(jax_weight(scheme, sig)),
                               rtol=1e-6)
    n = 50_000
    gen = torch.Generator().manual_seed(0)
    got = timestep_density_u(gen, scheme, n, 0.3, 0.7).numpy()
    want = np.asarray(jax_density(jax.random.PRNGKey(0), scheme, n, 0.3,
                                  0.7))
    assert abs(got.mean() - want.mean()) < 5e-3
    assert abs(got.std() - want.std()) < 5e-3
    if scheme == "mode":
        np.testing.assert_allclose(np.sort(got), np.sort(want), atol=5e-3)
    cfg = StraagTrainConfig(uniform_sampling=scheme == "none",
                            weighting_scheme=scheme)
    idx, noise = draw(cfg, {"latents": torch.zeros(64, 1, 2, 2, 4)}, gen)
    assert idx.shape == (64,) and noise.shape == (64, 1, 2, 2, 4)
    assert 0 <= int(idx.min()) and int(idx.max()) < 1000


def test_stratified_sampler_intervals():
    from more4d_tpu_torch.train import StratifiedTimestepSampler as Sampler

    s = Sampler(1000, uniform_sampling=True, world_size=4)
    assert s.group_num == 4 and s.sigma_interval == 250
    gen = torch.Generator().manual_seed(0)
    for rank in range(4):
        idx = s(gen, 64, rank=rank)
        assert idx.min() >= rank * 250 and idx.max() < (rank + 1) * 250
