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
time embedding). Remat on and off, and every remat policy, give identical
gradients (tolerance 0: a kept value is the one the backward's run would
compute again). CAME against JAX on an unscanned JAX DiT: CAME's RMS clip
runs over a whole tensor, and JAX's scanned blocks stack every layer into
one tensor (``ROADMAP.md`` Queue 3).
"""

import re

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
from more4d_tpu_torch.train.optim import (dynamic_clip_norm,
                                          global_grad_norm, make_optimizer)
from more4d_tpu_torch.train.train_straag import straag_loss, straag_update

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
              steps=3, trainable=None, batches=None, report=False):
    """Run ``steps`` steps of both trainers from the same params (on
    ``batches[i]``, default the fixture's batch each step); yield each
    step's (jax metrics, port metrics, jax params, jax ema, port params,
    port ema), the port's as copies. ``make_torch_opt`` takes the port's
    trainable (name, parameter) pairs."""
    jcfg, jdit, params, batch = models
    step = jax.jit(make_train_step(jdit, jax_tx, jcfg_train,
                                   trainable_filter=trainable,
                                   report_grad_norms=report))
    opt_state = jax_tx.init(params)
    jp, jema = params, jax.tree_util.tree_map(jnp.copy, params)
    dit = _port_dit(jcfg, params)
    if trainable is not None:
        for name, p in dit.named_parameters():
            p.requires_grad_(trainable(name))
    named = [(n, p) for n, p in dit.named_parameters() if p.requires_grad]
    opt, sched = make_torch_opt(named)
    update = straag_update([p for _, p in named], opt, tcfg_train, sched)
    ema = {n: p.detach().clone() for n, p in dit.named_parameters()}
    batches = batches or [batch] * steps
    key = jax.random.PRNGKey(3)
    for i in range(steps):
        key, sub = jax.random.split(key)
        idx, noise = _jax_draws(sub, jcfg_train, batch["latents"].shape)
        jp, opt_state, jema, jm = step(jp, opt_state, jema, batches[i], sub,
                                       i)
        tm = train_step(dit, update, ema, tcfg_train,
                        {k: torch.from_numpy(v)
                         for k, v in batches[i].items()},
                        idx, noise, i, report_grad_norms=report)
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


def _check_grad_norms(jm, tm, jcfg, params):
    """The port's per-parameter grad-norm report against JAX's dict
    (keystr -> norm): a JAX leaf's norm is the 2-norm of the port's norms
    of the tensors ``jax_param`` maps to it (a block leaf stacks the
    layers); a leaf the port does not train has a zero norm in JAX. rtol
    1e-5, atol 1e-7."""
    from more4d_tpu_torch.utils.quantize import jax_param

    paths = {n: jax_param(n, p)[0]
             for n, p in _port_dit(jcfg, params).named_parameters()}
    got = {}
    for name, norm in tm["grad_norms"].items():
        got[paths[name]] = got.get(paths[name], 0.0) + norm ** 2
    want = {"/".join(re.findall(r"\['([^']+)'\]", k)): float(v)
            for k, v in jm["grad_norms"].items()}
    assert set(got) <= set(want) and got
    for path, w in want.items():
        np.testing.assert_allclose(np.sqrt(got.get(path, 0.0)), w,
                                   rtol=1e-5, atol=1e-7, err_msg=path)


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
        lambda ps: (torch.optim.AdamW([p for _, p in ps], lr=1e-3, eps=1e-8,
                                      weight_decay=1e-4), None)))
    assert [s[1]["skipped"] for s in steps] == [False, False, True]
    for step in steps:
        _check_step(*step, jcfg)


def test_warmup_schedule_and_trainable_filter_match_jax(models):
    """The shipped AdamW (betas (0.9, 0.999), weight decay 3e-2, eps
    1e-10) under constant_with_warmup over 2 steps (lr 0, lr/2, lr: the
    first step's lr is 0 in both), with only the self-attention and the
    head trainable: frozen params get no update and no decay. The
    grad-norm report (--report_model_info) gives JAX's norms, after the
    step's clamp."""
    jcfg, _, params, _ = models
    kw = dict(learning_rate=1e-3, abnormal_loss_threshold=1e9)

    def trainable(path):
        return "self_attn" in path or "head" in path

    steps = list(_run_both(
        models, JaxCfg(**kw), StraagTrainConfig(**kw),
        jax_make_adamw(jax_make_lr_schedule(1e-3, "constant_with_warmup",
                                            2)),
        lambda ps: make_adamw(ps, make_lr_schedule(
            1e-3, "constant_with_warmup", 2)), trainable=trainable,
        report=True))
    start = _port_dit(jcfg, params).state_dict()
    for i, step in enumerate(steps):
        _check_step(*step, jcfg)
        _check_grad_norms(step[0], step[1], jcfg, params)
        for name, p in step[4].items():
            moved = not torch.equal(p, start[name])
            assert moved == (i > 0 and trainable(name)), name


def _port_grads(dit, tb, idx, noise):
    straag_loss(dit, StraagTrainConfig(), tb, idx, noise).backward()
    return {n: p.grad for n, p in dit.named_parameters()}


def test_remat_gives_identical_gradients(models):
    jcfg, _, params, batch = models
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    idx, noise = draw(StraagTrainConfig(), tb, gen)
    grads = []
    for remat in (False, True):
        dit = _port_dit(jcfg, params, remat=remat)
        assert bool(dit.remat_blocks()) == remat
        grads.append(_port_grads(dit, tb, idx, noise))
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0)


def test_remat_fraction_and_unported_policies(models):
    """remat_fraction picks its blocks; every JAX remat policy is taken
    (an unknown one raises)."""
    from more4d_tpu.models.wan_dit import remat_policy_of
    from more4d_tpu_torch.nn.remat import REMAT_POLICIES, saved_names

    jcfg, _, params, _ = models
    dit = _port_dit(jcfg, params, remat=True, num_layers=2,
                    remat_fraction=0.5)
    assert dit.remat_blocks() == {0}
    for policy in REMAT_POLICIES:
        assert _port_dit(jcfg, params, remat=True,
                         remat_policy=policy).remat_blocks() == {0, 1}
        jax_policy = remat_policy_of(jax_dit_tiny(remat_policy=policy))
        assert (jax_policy is None) == (policy == "nothing")
    assert saved_names("flash_ffn_offload") == {
        "sa_q", "sa_k", "sa_v", "sa_o", "sa_lse", "ffn_hidden"}
    assert saved_names("flash_lite") == {"sa_o", "sa_lse"}
    with pytest.raises(ValueError, match="remat_policy"):
        _port_dit(jcfg, params, remat=True,
                  remat_policy="flash_heavy").remat_blocks()


@pytest.fixture(scope="module")
def jax_grads(models):
    """JAX's gradients of the flow-matching loss on JAX's draws, with the
    port's batch, indices and noise."""
    jcfg, jdit, params, batch = models
    idx, noise = _jax_draws(jax.random.PRNGKey(7), JaxCfg(),
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
    return idx, noise, float(jloss), jgrads


@pytest.mark.parametrize("policy", ["dots", "flash_lite", "flash",
                                    "flash_ffn", "flash_offload",
                                    "flash_lite_offload",
                                    "flash_ffn_offload"])
def test_remat_policies_give_nothings_gradients(models, jax_grads, policy):
    """Each policy's gradients equal 'nothing''s bit for bit and JAX's
    within GRAD_ATOL. In the backward, the 'flash*' policies run the
    attention forward only for the two cross-attentions of each block
    (K1's plain version: 4 calls, against 6 under 'nothing'), and 'dots'
    runs no matrix product again (as many mm/addmm as the backward
    without remat; 'nothing' reruns every block's)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from more4d_tpu_torch.kernels import flash_attention as fa

    jcfg, _, params, batch = models
    idx, noise, _, jgrads = jax_grads
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.matmuls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.matmuls += 1
            return func(*args, **(kwargs or {}))

    counts, grads = {}, {}
    real = fa.flash_attention_plain
    for pol in ("none", "nothing", policy):
        calls = []

        def counted(*a, **k):
            calls.append(1)
            return real(*a, **k)

        dit = (_port_dit(jcfg, params) if pol == "none" else
               _port_dit(jcfg, params, remat=True, remat_policy=pol))
        loss = straag_loss(dit, StraagTrainConfig(), tb, idx, noise)
        fa.flash_attention_plain = counted
        try:
            with Count() as mode:
                loss.backward()
        finally:
            fa.flash_attention_plain = real
        counts[pol] = (len(calls), mode.matmuls)
        grads[pol] = {n: p.grad for n, p in dit.named_parameters()}
    assert counts["none"][0] == 0 and counts["nothing"][0] == 6
    assert counts["nothing"][1] > counts["none"][1]
    if policy == "dots":
        assert counts[policy] == (6, counts["none"][1])
    else:
        assert counts[policy][0] == 4
    for name, g in grads["nothing"].items():
        torch.testing.assert_close(grads[policy][name], g, rtol=0, atol=0)
    _assert_tree_close(grads[policy], jgrads, jcfg, "grad")


def test_jax_param_paths_are_the_jax_trees(models):
    """``utils/quantize.jax_param`` names every port DiT tensor by its
    leaf in the JAX tree, with that leaf's rank (the blocks' leaves stacked
    over the layers): the paths the two-tier LR and --trainable_modules
    match on."""
    from more4d_tpu_torch.utils.quantize import jax_param

    jcfg, _, params, _ = models
    leaves = {"/".join(re.findall(r"\['([^']+)'\]",
                                  jax.tree_util.keystr(kp))): np.ndim(v)
              for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = {}
    for name, p in _port_dit(jcfg, params).named_parameters():
        path, rank = jax_param(name, p)
        got[path] = rank
    assert got == leaves


def test_accumulation_with_a_skip_matches_jax_multisteps(models):
    """grad_accum_steps 2 with the clamp on the mean (clip_in_tx; JAX:
    MultiSteps(chain(dynamic_clip_transform, adamw))) over 4 micro-steps,
    the second skipped (a batch whose loss passes the threshold): the
    optimizer steps at micro-step 2 on the mean of micro-steps 0 and 2
    and not after 3; params and EMA move only then. The grad-norm report
    is of each micro-step's raw gradient, as JAX's. The same tolerances
    as the step."""
    from more4d_tpu.train.optim import dynamic_clip_transform

    jcfg, _, _, batch = models
    kw = dict(learning_rate=1e-3, abnormal_loss_start_step=-1,
              abnormal_loss_threshold=50.0, ema_decay=0.5,
              grad_accum_steps=2, clip_in_tx=True, grad_clip_decay_steps=4)
    big = dict(batch, latents=batch["latents"] * 30.0)
    jax_tx = optax.MultiSteps(optax.chain(
        dynamic_clip_transform(0.05, decay_steps=4),
        optax.adamw(1e-3)), every_k_schedule=2)
    steps = list(_run_both(
        models, JaxCfg(**kw), StraagTrainConfig(**kw), jax_tx,
        lambda ps: (torch.optim.AdamW([p for _, p in ps], lr=1e-3,
                                      eps=1e-8, weight_decay=1e-4), None),
        steps=4, batches=[batch, big, batch, batch], report=True))
    assert [s[1]["skipped"] for s in steps] == [False, True, False, False]
    assert [s[1]["updated"] for s in steps] == [0.0, 0.0, 1.0, 0.0]
    start = _port_dit(jcfg, models[2]).state_dict()
    for i, step in enumerate(steps):
        _check_step(*step, jcfg)
        _check_grad_norms(step[0], step[1], jcfg, models[2])
        moved = any(not torch.equal(p, start[n]) for n, p in step[4].items())
        assert moved == (i >= 2), i


LOW_LR = "ffn/fc1|text_fc|self_attn/q"


def test_two_tier_lr_adamw_matches_jax(models):
    """--low_lr_names on the JAX paths (the regex names JAX's ffn/fc1 and
    text_fc leaves, which the port calls ffn.0 and text_embedding.0) at
    ratio 0.1 under the warmup schedule, AdamW against JAX's make_adamw
    through two train steps: the step's tolerances."""
    jcfg, _, params, _ = models
    lr = make_lr_schedule(1e-3, "constant_with_warmup", 1)
    jax_tx = jax_make_adamw(jax_make_lr_schedule(1e-3, "constant_with_warmup",
                                                 1),
                            low_lr_names=LOW_LR, low_lr_ratio=0.1,
                            params=params)
    kw = dict(learning_rate=1e-3, abnormal_loss_threshold=1e9)
    for step in _run_both(models, JaxCfg(**kw), StraagTrainConfig(**kw),
                          jax_tx, lambda ps: make_adamw(
                              ps, lr, low_lr_names=LOW_LR, low_lr_ratio=0.1),
                          steps=2):
        _check_step(*step, jcfg)
    opt = make_adamw(_port_dit(jcfg, params).named_parameters(), lr,
                     low_lr_names=LOW_LR)[0]
    # fc1's and the self-attention q's weight and bias a layer, text_fc1/2
    assert len(opt.param_groups[1]["params"]) == 4 * DIT["num_layers"] + 4


def test_two_tier_lr_came_matches_jax(models, jax_grads):
    """The same two groups with CAME (at its weight decay 1e-2) against
    with_low_lr(came): two updates of JAX's gradients, on an unscanned JAX
    tree (CAME's RMS clip runs over a whole tensor, and the scan stacks
    the layers into one), the conv kernels left out of the comparison
    (CAME factors a tensor's last two dims: JAX's conv kernels end in (in,
    out), torch's in the kernel's (h, w), as the reference's). atol 1e-6
    (the same gradients; CAME's sums in other orders). Fed the train step
    instead, CAME turns the last-bit gradient differences of near-zero
    rows into full-size updates."""
    from more4d_tpu.train.optim import came as jax_came
    from more4d_tpu.train.optim import with_low_lr

    jcfg, _, params, _ = models
    grads = jax_grads[3]

    def unscanned(tree):
        p = tree["params"]
        return {"params": {
            **{k: v for k, v in p.items() if k != "blocks"},
            **{f"blocks_{i}": jax.tree_util.tree_map(
                lambda a: a[i], p["blocks"]["block"])
               for i in range(DIT["num_layers"])}}}

    jp, jg = unscanned(params), unscanned(grads)
    tx = with_low_lr(jax_came, jax_make_lr_schedule(
        1e-3, "constant_with_warmup", 1), LOW_LR, 0.1, jp)
    state = tx.init(jp)
    dit = _port_dit(jcfg, params)
    opt, sched = make_optimizer("came", dit.named_parameters(),
                                make_lr_schedule(1e-3, "constant_with_warmup",
                                                 1), weight_decay=1e-2,
                                low_lr_names=LOW_LR, low_lr_ratio=0.1)
    port_g = dit_state_dict(grads, _torch_cfg(jcfg))
    update = jax.jit(tx.update)
    for _ in range(2):
        upd, state = update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        for name, p in dit.named_parameters():
            p.grad = port_g[name].clone()
        opt.step()
        sched.step()
    want = dit_state_dict(jp, _torch_cfg(jcfg))
    start = dit_state_dict(params, _torch_cfg(jcfg))
    moved = 0.0
    for name, p in dit.named_parameters():
        if "patch_embedding" in name or "feature_adapter" in name:
            continue
        err = (p.detach() - want[name]).abs().max().item()
        assert err < 1e-6, f"{name}: {err}"
        moved = max(moved, (want[name] - start[name]).abs().max().item())
    assert moved > 1e-4


def test_schedule_skip_rule_and_clip_match_jax():
    np.testing.assert_array_equal(training_schedule(),
                                  jax_training_schedule())
    cfg = StraagTrainConfig(abnormal_loss_start_step=5)
    assert should_skip_update(float("nan"), 0, cfg)
    assert not should_skip_update(1.0, 5, cfg)
    assert should_skip_update(1.0, 6, cfg)
    # with accumulation the rule counts optimizer steps (JAX's sched_step)
    accum = StraagTrainConfig(abnormal_loss_start_step=5, grad_accum_steps=2)
    assert not should_skip_update(1.0, 11, accum)
    assert should_skip_update(1.0, 12, accum)
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
