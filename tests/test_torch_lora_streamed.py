"""The port's streamed-base LoRA trainer
(``more4d_tpu_torch/train/lora_streamed.py``) against the port's resident
ViSM step and against the JAX ``StreamedLoRATrainer``, on the CPU in
float32 (on the CPU each block runs on its host buffer; the copies, events
and pinned activations run on the card in ``chip_smoke.py``'s
``vism14b_phase``).

The JAX trainer walks its backward in chunks of ``bwd_chunk`` blocks; the
port walks it in one loop, so both chunk sizes compare to the same port
step.

Tolerances (float32): the loss to 1e-5 relative; the factors after SGD
steps to 1e-5 relative and 1e-6 absolute. The streamed step adds LoRA as
a side path, x W^T + s (x down^T) up^T, where the resident step merges W
+ s up down: the same product in another summation order. With fp8 host
blocks both packages widen the same fp8 bytes, so the same tolerance
holds.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_vism as tv
from more4d_tpu.train.lora_streamed import \
    make_streamed_lora_trainer as jax_make_streamed
from more4d_tpu.train.train_vism import VismTrainConfig as JaxCfg
from more4d_tpu.train.train_vism import make_vism_train_step
from more4d_tpu_torch.train.lora_streamed import (StreamedLoRATrainer,
                                                  lora_block_paths,
                                                  make_streamed_lora_trainer)
from more4d_tpu_torch.train.optim import GradUpdate
from more4d_tpu_torch.train.train_vism import (VismTrainConfig, factor_leaves,
                                               train_step)

LR = 0.1
STEPS = 2


@pytest.fixture(scope="module")
def dit_pair():
    return tv.jax_dit(seed=7)


def _port_streamed(params, jl, quantize="none", acts_on_host=False,
                   cfg=VismTrainConfig()):
    trainer, lora = make_streamed_lora_trainer(
        tv.port_dit(params), cfg, torch.Generator().manual_seed(0),
        rank=2, alpha=2.0, quantize=quantize, device="cpu",
        acts_on_host=acts_on_host)
    want = tv.port_lora(jl)
    assert set(lora["factors"]) == set(want["factors"])
    return trainer, want


def _draws(i):
    b = tv.batch(10 + i)
    idx, noise = tv.jax_draws(jax.random.PRNGKey(20 + i),
                              b["latents"].shape)
    return b, jax.random.PRNGKey(20 + i), idx, noise


def _port_steps(step_fn, lora):
    leaves = factor_leaves(lora)
    update = GradUpdate(leaves, torch.optim.SGD(leaves, lr=LR))
    losses = []
    for i in range(STEPS):
        b, _, idx, noise = _draws(i)
        losses.append(step_fn(lora, update, tv.torch_batch(b), idx,
                              noise)["loss"])
    return losses


@pytest.mark.parametrize("acts_on_host", [False, True])
def test_streamed_step_matches_resident(dit_pair, acts_on_host):
    _, params = dit_pair
    jl = tv.jax_lora(params)
    trainer, ls = _port_streamed(params, jl, acts_on_host=acts_on_host)
    got = _port_steps(trainer.train_step, ls)
    dit = tv.port_dit(params)
    lr = tv.port_lora(jl)
    want = _port_steps(lambda lora, u, b, i, n: train_step(
        dit, u, VismTrainConfig(), lora, b, i, n), lr)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name, f in lr["factors"].items():
        for k in ("down", "up"):
            np.testing.assert_allclose(
                ls["factors"][name][k].detach().numpy(),
                f[k].detach().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("quantize,bwd_chunk", [("none", 1), ("none", 4),
                                                ("fp8", 4)])
def test_streamed_step_matches_jax(dit_pair, quantize, bwd_chunk):
    """bwd_chunk 1 walks the JAX backward in three one-block chunks, 4 in
    one partial chunk; fp8 host blocks widen the same bytes on both
    sides."""
    model, params = dit_pair
    jl = tv.jax_lora(params)
    trainer, ls = _port_streamed(params, jl, quantize=quantize)
    tx = optax.sgd(LR)
    jtrainer, jlora, _ = jax_make_streamed(
        model, params, tx, jax.random.PRNGKey(0), rank=2, alpha=2.0,
        quantize=quantize, bwd_chunk=bwd_chunk)
    # the JAX update donates its factors: hand it copies
    jlora = {**jlora, "factors": jax.tree.map(jnp.copy, jl["factors"])}
    opt_state = tx.init(jlora["factors"])
    jlosses = []
    for i in range(STEPS):
        b, key, _, _ = _draws(i)
        jlora, opt_state, m = jtrainer.train_step(jlora, opt_state, b, key)
        jlosses.append(float(m["loss"]))
    got = _port_steps(trainer.train_step, ls)
    np.testing.assert_allclose(got, jlosses, rtol=1e-5)
    tv.assert_factors_close(ls, jlora)


def test_streamed_density_sampling_and_skip_name_match_jax(dit_pair):
    """The SD3 weighting reaches the streamed loss tail, and
    --lora_skip_name the streamed factors, as in the resident step."""
    model, params = dit_pair
    kw = dict(uniform_sampling=False, weighting_scheme="cosmap")
    jl = tv.jax_lora(params, skip_name="ffn")
    tx = optax.sgd(LR)
    step = jax.jit(make_vism_train_step(model, tx, JaxCfg(**kw)))
    b = tv.batch(3)
    key = jax.random.PRNGKey(9)
    jl2, _, m = step(jl, tx.init(jl["factors"]), params, b, key)
    trainer, lora = make_streamed_lora_trainer(
        tv.port_dit(params), VismTrainConfig(**kw),
        torch.Generator().manual_seed(0), rank=2, alpha=2.0,
        quantize="none", skip_name="ffn", device="cpu")
    assert not any("ffn" in n for n in lora["factors"])
    lora = tv.port_lora(jl)
    leaves = factor_leaves(lora)
    idx, noise = tv.jax_draws(key, b["latents"].shape, False, "cosmap")
    tm = trainer.train_step(lora, GradUpdate(
        leaves, torch.optim.SGD(leaves, lr=LR)), tv.torch_batch(b), idx,
        noise)
    np.testing.assert_allclose(tm["loss"], float(m["loss"]), rtol=1e-5)
    tv.assert_factors_close(lora, jl2)


def test_lora_block_paths():
    paths = lora_block_paths({"blocks.3.self_attn.q.weight": 0,
                              "blocks.3.ffn.0.weight": 0,
                              "blocks.12.cross_attn.k_img.weight": 0,
                              "head.head.weight": 0})
    assert paths == {3: {"self_attn.q": "blocks.3.self_attn.q.weight",
                         "ffn.0": "blocks.3.ffn.0.weight"},
                     12: {"cross_attn.k_img":
                          "blocks.12.cross_attn.k_img.weight"}}


def _counted_steps(trainer, lora, record):
    """STEPS AdamW steps of ``trainer`` on the same draws, under a
    profiler that records the host when ``record``; (each step's loss,
    the gradients the update got, the factors after it, the side paths
    counted)."""
    from more4d_tpu_torch.train.optim import make_adamw

    leaves = factor_leaves(lora)
    opt, _ = make_adamw(leaves, 1e-3)
    update = GradUpdate(leaves, opt)
    grads = []

    def recorded(gs):
        grads.append([g.clone() for g in gs])
        return update(gs)
    before = StreamedLoRATrainer.side_paths
    with (profile(activities=[ProfilerActivity.CPU]) if record
          else contextlib.nullcontext()):
        losses = []
        factors = []
        for i in range(STEPS):
            b, _, idx, noise = _draws(i)
            losses.append(trainer.train_step(lora, recorded,
                                             tv.torch_batch(b), idx,
                                             noise)["loss"])
            factors.append([p.detach().clone() for p in leaves])
    return losses, grads, factors, StreamedLoRATrainer.side_paths - before


@pytest.mark.parametrize("quantize", ["none", "fp8"])
def test_the_spans_and_the_side_path_counter_leave_a_step_bit_identical(
        dit_pair, quantize):
    """With a profiler recording (the spans entered) and without (the
    shared no-op context), the same steps give the same bits: loss,
    gradients and factors; both count 12 side paths a block, in each
    walk."""
    _, params = dit_pair
    jl = tv.jax_lora(params)
    runs = []
    for record in (False, True):
        trainer, lora = _port_streamed(params, jl, quantize=quantize)
        runs.append(_counted_steps(trainer, lora, record))
    (l0, g0, f0, n0), (l1, g1, f1, n1) = runs
    assert l0 == l1
    for a, b in zip(g0 + f0, g1 + f1):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert n0 == n1 == STEPS * 2 * tv.DIT["num_layers"] * 12


def test_a_step_opens_each_lora_span_once_and_the_side_span_per_side_path(
        dit_pair):
    _, params = dit_pair
    trainer, lora = _port_streamed(params, tv.jax_lora(params),
                                   quantize="fp8")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _counted_steps(trainer, lora, record=False)
    spans = sorted(((e.name, e.time_range.start) for e in prof.events()
                    if e.name.startswith("more4d.lora.")),
                   key=lambda s: s[1])
    names = [n for n, _ in spans]
    parts = [n for n in names if n != "more4d.lora.side"]
    assert parts == ["more4d.lora.forward_walk", "more4d.lora.loss",
                     "more4d.lora.backward_walk",
                     "more4d.lora.update"] * STEPS
    assert names.count("more4d.lora.side") == \
        STEPS * 2 * tv.DIT["num_layers"] * 12
