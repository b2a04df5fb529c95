"""The port's ViSM LoRA step (``more4d_tpu_torch/train/train_vism.py``)
against the JAX ``make_vism_train_step``, on the CPU in float32: a tiny InP
DiT from the same numpy weights, the same LoRA carried across by
``convert.lora_factors`` (its up factors drawn, so every factor has a
gradient), and the JAX step's own timestep and noise draws handed to the
port.

Tolerances (float32, the two sides sum in other orders): the loss to 1e-5
relative; the factors after an SGD step to 1e-5 relative and 1e-6
absolute (the update is linear in the clipped gradient, so this holds the
gradient itself); after an AdamW step to 1e-5 absolute at lr 1e-3, 1% of
a step (AdamW divides each gradient by its running magnitude, which
lifts a last-bit difference of a tiny gradient, as
``tests/test_torch_train.py`` notes).
"""

import jax
import numpy as np
import optax
import pytest
import torch

import _torch_vism as tv
from more4d_tpu.train.train_vism import TE_LORA_TARGETS as JAX_TE_TARGETS
from more4d_tpu.train.train_vism import VismTrainConfig as JaxCfg
from more4d_tpu.train.train_vism import make_vism_train_step
from more4d_tpu_torch.train.lora import TE_LORA_TARGETS, create_lora
from more4d_tpu_torch.train.optim import GradUpdate, make_adamw
from more4d_tpu_torch.train.train_vism import (VismTrainConfig, factor_leaves,
                                               train_step)

LR = 0.1


@pytest.fixture(scope="module")
def dit_pair():
    model, params = tv.jax_dit()
    return model, params


def _run(dit_pair, cfg_kw, steps=1, skip_name=None, adamw=False,
         accum=1, remat=False):
    """``steps`` steps of both trainers from the same factors; returns
    (jax losses, port losses, jax lora, port lora)."""
    model, params = dit_pair
    jcfg, tcfg = JaxCfg(**cfg_kw), VismTrainConfig(**cfg_kw)
    jl = tv.jax_lora(params, skip_name=skip_name)
    tl = tv.port_lora(jl)
    if adamw:
        tx = optax.adamw(1e-3, eps=1e-10, weight_decay=3e-2)
        opt, _ = make_adamw(factor_leaves(tl), 1e-3)
    else:
        tx = optax.sgd(LR)
        opt = torch.optim.SGD(factor_leaves(tl), lr=LR)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    update = GradUpdate(factor_leaves(tl), opt, None, tcfg.max_grad_norm,
                        accum)
    step = jax.jit(make_vism_train_step(model, tx, jcfg))
    opt_state = tx.init(jl["factors"])
    dit = tv.port_dit(params, remat=remat)
    key = jax.random.PRNGKey(5)
    jlosses, tlosses = [], []
    for i in range(steps):
        b = tv.batch(i)
        key, sub = jax.random.split(key)
        idx, noise = tv.jax_draws(sub, b["latents"].shape,
                                  cfg_kw.get("uniform_sampling", True),
                                  cfg_kw.get("weighting_scheme", "none"))
        jl, opt_state, m = step(jl, opt_state, params, b, sub)
        tm = train_step(dit, update, tcfg, tl, tv.torch_batch(b), idx,
                        noise)
        jlosses.append(float(m["loss"]))
        tlosses.append(tm["loss"])
    return jlosses, tlosses, jl, tl


@pytest.mark.parametrize("remat", [False, True])
def test_resident_step_matches_jax(dit_pair, remat):
    """With remat the blocks run again in the backward, under the merged
    weights: the same numbers."""
    jloss, tloss, jl, tl = _run(dit_pair, {}, remat=remat)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    tv.assert_factors_close(tl, jl)


@pytest.mark.parametrize("variant", [
    dict(motion_sub_loss=True),
    dict(uniform_sampling=False, weighting_scheme="logit_normal"),
    dict(uniform_sampling=False, weighting_scheme="cosmap"),
    dict(max_grad_norm=1e-3),
])
def test_step_variants_match_jax(dit_pair, variant):
    """The motion_sub term, the SD3 density sampler and weighting, and a
    clip that binds."""
    jloss, tloss, jl, tl = _run(dit_pair, variant, steps=2)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    tv.assert_factors_close(tl, jl)


def test_skip_name_matches_jax(dit_pair):
    jloss, tloss, jl, tl = _run(dit_pair, {}, skip_name="ffn")
    assert tl["factors"] and not any("ffn" in n for n in tl["factors"])
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    tv.assert_factors_close(tl, jl)
    # the port's own create_lora drops the same weights
    names = set(create_lora(tv.port_dit(dit_pair[1]).state_dict(),
                            torch.Generator().manual_seed(0),
                            skip_name="ffn")["factors"])
    assert names == set(tl["factors"])


def test_adamw_steps_match_jax(dit_pair):
    jloss, tloss, jl, tl = _run(dit_pair, {}, steps=3, adamw=True)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    tv.assert_factors_close(tl, jl, rtol=0, atol=1e-5)


@pytest.mark.parametrize("adamw", [False, True])
def test_grad_accumulation_matches_multisteps(dit_pair, adamw):
    """grad_accum_steps=2: the step clips each micro-step's gradient, the
    mean of two is applied on the second (optax.MultiSteps)."""
    jloss, tloss, jl, tl = _run(dit_pair, dict(max_grad_norm=0.05),
                                steps=4, adamw=adamw, accum=2)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    if adamw:
        tv.assert_factors_close(tl, jl, rtol=0, atol=1e-5)
    else:
        tv.assert_factors_close(tl, jl)


def test_text_encoder_lora_step_matches_jax(dit_pair):
    """--train_text_encoder: umT5 with its own merged factors inside the
    loss, its padded positions zeroed; both factor sets under one SGD."""
    model, params = dit_pair
    t5, te_params = tv.jax_t5()
    jl = {"dit": tv.jax_lora(params),
          "te": tv.jax_lora(te_params, seed=4, targets=JAX_TE_TARGETS)}
    assert jl["te"]["factors"]
    tl = {"dit": tv.port_lora(jl["dit"]),
          "te": tv.port_lora(jl["te"], t5=True)}
    port_t5 = tv.port_t5(te_params)
    # the port's target set names the same umT5 weights
    assert set(create_lora(port_t5.state_dict(),
                           torch.Generator().manual_seed(0),
                           targets=TE_LORA_TARGETS)["factors"]) \
        == set(tl["te"]["factors"])
    tx = optax.sgd(LR)
    opt_state = tx.init({"dit": jl["dit"]["factors"],
                         "te": jl["te"]["factors"]})
    step = jax.jit(make_vism_train_step(model, tx, JaxCfg(),
                                        text_encoder=t5))
    leaves = factor_leaves(tl)
    update = GradUpdate(leaves, torch.optim.SGD(leaves, lr=LR))
    dit = tv.port_dit(params)
    key = jax.random.PRNGKey(6)
    for i in range(2):
        b = tv.batch(i, te=True)
        key, sub = jax.random.split(key)
        idx, noise = tv.jax_draws(sub, b["latents"].shape)
        jl, opt_state, m = step(jl, opt_state,
                                {"dit": params, "te": te_params}, b, sub)
        tm = train_step(dit, update, VismTrainConfig(), tl,
                        tv.torch_batch(b), idx, noise, text_encoder=port_t5)
        np.testing.assert_allclose(tm["loss"], float(m["loss"]), rtol=1e-5)
    tv.assert_factors_close(tl["dit"], jl["dit"])
    tv.assert_factors_close(tl["te"], jl["te"], t5=True)
    moved = max((f["up"].detach() - g["up"]).abs().max().item()
                for f, g in zip(tl["te"]["factors"].values(),
                                tv.port_lora(tv.jax_lora(
                                    te_params, seed=4,
                                    targets=JAX_TE_TARGETS),
                                    t5=True)["factors"].values()))
    assert moved > 0
