"""The port's VAE-adaptor trainer (``more4d_tpu_torch/train/train_vae.py``
and the CLI loop of ``scripts/train_vae.py``) against the JAX
``make_vae_adaptor_train_step``, on the CPU in float32: a tiny VAE and
adaptors from the same numpy weights, the JAX step's posterior noise
handed to the port.

Tolerances (float32): the loss, its reconstruction and KL terms to 1e-5
relative; the trainable weights after two SGD steps to 1e-5 relative and
1e-6 absolute (the update is linear in the clipped gradient). A gradient
step checkpoints the VAE's stage layers and the adaptors' res blocks; the
same step with checkpointing replaced by direct calls gives the same
numbers, held to the same tolerance.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from more4d_tpu.config import VAEConfig as JaxVAEConfig
from more4d_tpu.models.adaptors import VAEDecoderAdaptor as JaxDec
from more4d_tpu.models.adaptors import VAEEncoderAdaptor as JaxEnc
from more4d_tpu.models.wan_vae import WanVAE as JaxVAE
from more4d_tpu.train.train_vae import VAEAdaptorTrainConfig as JaxCfg
from more4d_tpu.train.train_vae import make_vae_adaptor_train_step
from more4d_tpu_torch.config import VAEConfig
from more4d_tpu_torch.convert import adaptor_state_dict, vae_state_dict
from more4d_tpu_torch.models import (VAEDecoderAdaptor, VAEEncoderAdaptor,
                                     WanVAE)
from more4d_tpu_torch.train.train_vae import (VAEAdaptorTrainConfig,
                                              train_step, trainable_params)
from more4d_tpu_torch.train.optim import GradUpdate

VAE = dict(dim=4, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
           temporal_downsample=(False, True, True))
T, H, W, CH = 5, 32, 32, 8
LR = 0.01


def _random(tree, seed, std=0.1):
    leaves, td = jax.tree_util.tree_flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        td, [jnp.asarray(rs.normal(0, std, l.shape), jnp.float32)
             for l in leaves])


@pytest.fixture(scope="module")
def models():
    """JAX modules and random params: the VAE's own, the adaptors' drawn
    N(0, 0.1) (the encoder adaptor's zero conv_out would give it no
    gradient at init)."""
    vae, enc, dec = JaxVAE(JaxVAEConfig(**VAE)), JaxEnc(ch=CH), JaxDec(ch=CH)
    x = jnp.zeros((1, T, H, W, 3), jnp.float32)
    vp = vae.init(jax.random.PRNGKey(0), x)
    ep = _random(enc.init(jax.random.PRNGKey(1), x), 1)
    dp = _random(dec.init(jax.random.PRNGKey(2), x), 2)
    return vae, enc, dec, vp, ep, dp


def _port(vp, ep, dp):
    vae = WanVAE(VAEConfig(**VAE))
    vae.load_state_dict(vae_state_dict(vp, vae.cfg), strict=True)
    enc, dec = VAEEncoderAdaptor(ch=CH), VAEDecoderAdaptor(ch=CH)
    enc.load_state_dict(adaptor_state_dict(ep, decoder=False))
    dec.load_state_dict(adaptor_state_dict(dp, decoder=True))
    return vae, enc, dec


def _flow(seed):
    return np.random.RandomState(seed).randn(1, T, H, W, 3).astype(
        np.float32) * 0.3


def _noise(key):
    return torch.from_numpy(np.array(jax.random.normal(
        key, (1, (T - 1) // 4 + 1, H // 8, W // 8, 4), jnp.float32)))


def _both(models, cfg_kw, steps=2):
    vae_j, enc_j, dec_j, vp, ep, dp = models
    jcfg, tcfg = JaxCfg(**cfg_kw), VAEAdaptorTrainConfig(**cfg_kw)
    tr = {"enc": ep, "dec": dp}
    if jcfg.finetune_decoder:
        tr["vae_decoder"] = {"decoder": vp["params"]["decoder"],
                             "conv2": vp["params"]["conv2"]}
    tx = optax.sgd(LR)
    opt_state = tx.init(tr)
    step = jax.jit(make_vae_adaptor_train_step(enc_j, dec_j, vae_j, tx,
                                               jcfg))
    vae, enc, dec = _port(vp, ep, dp)
    params = trainable_params(enc, dec, vae, tcfg)
    update = GradUpdate(params, torch.optim.SGD(params, lr=LR),
                        max_grad_norm=tcfg.max_grad_norm, clip_mean=True)
    for i in range(steps):
        flow, key = _flow(i), jax.random.PRNGKey(30 + i)
        tr, opt_state, jm = step(tr, opt_state, vp, {"flow": flow}, key)
        tm = train_step(enc, dec, vae, params, update, tcfg,
                        {"flow": torch.from_numpy(flow)}, _noise(key))
        for k in ("loss", "nll_loss", "kl_loss"):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    return tr, (vae, enc, dec)


def _assert_trained_close(tr, port, vp):
    vae, enc, dec = port
    for name, want in (("enc", adaptor_state_dict(tr["enc"], False)),
                       ("dec", adaptor_state_dict(tr["dec"], True))):
        got = (enc if name == "enc" else dec).state_dict()
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {k}")
    if "vae_decoder" in tr:
        params = {**vp["params"], **tr["vae_decoder"]}
        want = vae_state_dict({"params": params}, vae.cfg)
        got = vae.state_dict()
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("cfg_kw", [
    {},
    dict(rec_loss="l2"),
    dict(finetune_decoder=False),
    dict(encoder_grad_through_vae=False),
])
def test_step_matches_jax(models, cfg_kw):
    tr, port = _both(models, cfg_kw)
    _assert_trained_close(tr, port, models[3])


def test_gradient_checkpointing_gives_the_same_step(models, monkeypatch):
    """The step checkpoints (counted), and with ``checkpoint`` replaced by
    a direct call it still matches the JAX step."""
    import torch.utils.checkpoint as tuc

    calls = []
    real = tuc.checkpoint

    def counted(fn, *a, **kw):
        calls.append(fn)
        return real(fn, *a, **kw)

    monkeypatch.setattr(tuc, "checkpoint", counted)
    _both(models, {}, steps=1)
    assert len(calls) > 0
    monkeypatch.setattr(tuc, "checkpoint",
                        lambda fn, *a, use_reentrant=None: fn(*a))
    tr, port = _both(models, {})
    _assert_trained_close(tr, port, models[3])


def _cli_args(**over):
    """The adaptor CLI's arguments at its defaults, with these."""
    from more4d_tpu_torch.scripts.train_vae import build_parser

    args = build_parser().parse_args(["--video_list", "-", "--vae_ckpt",
                                      "-"])
    for k, v in over.items():
        setattr(args, k, v)
    return args


@pytest.mark.parametrize("accum", [1, 2])
def test_cli_loop_checkpoints_and_resumes(models, tmp_path, accum):
    """The CLI loop (``run_training``) on the CPU: finite losses, a
    checkpoint the inference CLIs' adaptor loader reads (the fine-tuned VAE
    decoder included), and a resume that continues from it to the same
    weights as the uninterrupted run."""
    from more4d_tpu_torch.models.adaptors import load_adaptor
    from more4d_tpu_torch.scripts.train_vae import run_training
    from more4d_tpu_torch.train.checkpoint import CheckpointManager

    vp, ep, dp = models[3:]

    def args(out, steps, resume=False):
        return _cli_args(
            learning_rate=1e-4, kl_scale=1e-6, finetune_vae_decoder=True,
            rec_loss="l1", output_dir=str(out), max_steps=steps,
            checkpointing_steps=2, log_steps=1, seed=0, resume=resume,
            grad_accum_steps=accum, lr_scheduler="constant_with_warmup",
            lr_warmup_steps=1, max_grad_norm=1.0)

    def samples():
        i = 0
        while True:
            yield _flow(100 + i)[0]
            i += 1

    full = run_training(*_port(vp, ep, dp), samples(),
                        args(tmp_path / "a", 4), device="cpu")
    lines = [json.loads(line) for line in
             open(os.path.join(tmp_path / "a", "metrics.jsonl"))]
    assert [r["step"] for r in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(r["train/loss"]) for r in lines)
    assert CheckpointManager(str(tmp_path / "a")).latest_step() == 4
    dec_sd, vae_ft = load_adaptor(str(tmp_path / "a"), decoder=True)
    assert vae_ft is not None and any(k.startswith("decoder.")
                                      for k in vae_ft)
    for k, v in full["dec"].items():
        assert torch.equal(dec_sd[k], v)

    run_training(*_port(vp, ep, dp), samples(), args(tmp_path / "b", 2),
                 device="cpu")
    rest = samples()
    next(rest), next(rest)
    resumed = run_training(*_port(vp, ep, dp), rest,
                           args(tmp_path / "b", 4, resume=True),
                           device="cpu")
    for part in ("enc", "dec", "vae_decoder"):
        for k, v in full[part].items():
            np.testing.assert_allclose(resumed[part][k].numpy(),
                                       v.numpy(), rtol=0, atol=1e-7)


def test_cli_loop_skips_outliers(models, tmp_path):
    """A loss past --loss_skip_absolute_threshold is dropped: logged as
    skipped, the weights kept."""
    from more4d_tpu_torch.scripts.train_vae import run_training

    vp, ep, dp = models[3:]
    vae, enc, dec = _port(vp, ep, dp)
    before = {k: v.clone() for k, v in dec.state_dict().items()}
    args = _cli_args(
        learning_rate=1e-2, kl_scale=1e-6, finetune_vae_decoder=True,
        rec_loss="l1", output_dir=str(tmp_path), max_steps=2,
        checkpointing_steps=100, log_steps=1, seed=0, resume=False,
        loss_skip_absolute_threshold=1e-3)
    run_training(vae, enc, dec, iter([_flow(1)[0], _flow(2)[0]]), args,
                 device="cpu")
    lines = [json.loads(line) for line in
             open(os.path.join(tmp_path, "metrics.jsonl"))]
    assert sum(r.get("train/skipped_outlier", 0) for r in lines) == 2
    for k, v in dec.state_dict().items():
        assert torch.equal(v, before[k])
