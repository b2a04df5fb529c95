"""The 4D-STraG trainer on a device mesh: the port's ``StraagTrainer`` on
two gloo ranks (``fsdp=2``: parameters, AdamW state and EMA sharded;
``data=2``: a row a rank) against the JAX ``StraagTrainer`` on
``create_mesh(MeshConfig(data=2, fsdp=4))`` over the virtual 8-device CPU
mesh, at the tiny sizes of ``tests/test_torch_train_harness.py``.

Both trainers take the same global batches of two samples, the same
dropouts (numpy ``RandomState(seed)``) and JAX's timesteps and noise for
the whole batch (the port's ``harness.draw`` is replaced by the JAX
step's own draws: ``_jax_draws``), so the sampler is held apart from the
step. Tolerance (fp32 on the CPU, sums in other orders): losses and grad
norms 1e-5 relative, params and EMA 1e-5 absolute after two AdamW steps.

Checkpoints: the ``fsdp=2`` run's step-1 checkpoint (gathered whole,
written by rank 0) resumes in one process and ends on the two-rank run's
params; a one-process step-1 checkpoint resumes on the ``data=2`` mesh.
Accumulation over 2 micro-steps on ``data=2`` gives the one-process
run's numbers (the one-process accumulation is held to JAX's
``MultiSteps`` by ``tests/test_torch_train_harness.py``).

The sampler fault: JAX's harness calls its step without a rank, so with
``world_size`` 2 and uniform sampling every row's timestep lies in group
0's half [0, 500); the port stratifies each row by its data shard.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from more4d_tpu.config import VAEConfig as JaxVAEConfig
from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.data.sceneflow import SceneFlowSample as JaxSample
from more4d_tpu.models import WanDiT as JaxWanDiT
from more4d_tpu.models.adaptors import VAEEncoderAdaptor as JaxEncAdaptor
from more4d_tpu.models.wan_vae import WanVAE as JaxWanVAE
from more4d_tpu.parallel import MeshConfig, create_mesh
from more4d_tpu.train import train_straag as jax_train_straag
from more4d_tpu.train.harness import StraagRunConfig as JaxRunConfig
from more4d_tpu.train.harness import StraagTrainer as JaxTrainer
from more4d_tpu.train.sampler import StratifiedTimestepSampler as JaxSampler
from more4d_tpu.train.train_straag import StraagTrainConfig as JaxTrainConfig
from more4d_tpu_torch.config import VAEConfig, dit_tiny
from more4d_tpu_torch.convert import (adaptor_state_dict, dit_state_dict,
                                      vae_state_dict)
from more4d_tpu_torch.data import SceneFlowSample
from more4d_tpu_torch.train import StraagTrainConfig, draw

T, H, W = 5, 32, 32
VAE = dict(dim=4, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
           temporal_downsample=(False, True, True))
DIT = dict(in_dim=16, out_dim=4, motion_guidance=True, dim=32, ffn_dim=64,
           num_heads=2, num_layers=2, text_dim=16, clip_dim=16, text_len=8)
ENC_CH = 8
BATCH, STEPS, SEED = 2, 2, 3
RUN = dict(batch_size=BATCH, max_steps=STEPS, checkpointing_steps=1,
           log_steps=1, seed=SEED, control_dropout=0.5, clip_dropout=0.5,
           text_dropout=0.5)
# world_size 2: the JAX CLI's value under --mesh data=2
TCFG = dict(learning_rate=1e-4, abnormal_loss_threshold=1e9, world_size=2)


def _random_params(init, seed, std, *args, **kw):
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args, **kw)
    leaves, td_ = jax.tree_util.tree_flatten(shapes)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        td_, [np.asarray(rs.normal(0, std, l.shape), np.float32)
              for l in leaves])


def _jax_draws(key, shape):
    """make_train_step's draws for one step on the global batch: rank 0,
    as the JAX harness calls it."""
    rng_t, rng_n = jax.random.split(key)
    idx = JaxSampler(1000, uniform_sampling=True,
                     world_size=TCFG["world_size"])(rng_t, shape[0])
    noise = jax.random.normal(rng_n, shape, jnp.float32)
    return np.asarray(idx).astype(np.int64), np.array(noise)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two steps of the JAX trainer on data=2 x fsdp=4, its metrics, its
    params after each step, its draws and the timesteps its sampler drew
    (read out of the jitted step)."""
    jvae = JaxWanVAE(JaxVAEConfig(**VAE))
    vae_p = _random_params(jvae.init, 1, 0.2, jnp.zeros((1, T, H, W, 3)))
    jcfg = jax_dit_tiny(dtype=jnp.float32, **DIT)
    lt, lh, lw = (T - 1) // 4 + 1, H // 8, W // 8
    dit_p = _random_params(
        JaxWanDiT(jcfg).init, 2, 0.04, jnp.zeros((1, lt, lh, lw, 4)),
        jnp.zeros((1,)), jnp.zeros((1, 8, 16)),
        y=jnp.zeros((1, lt, lh, lw, 12)),
        clip_fea=jnp.zeros((1, jcfg.clip_tokens, 16)),
        mpm_features=jnp.zeros((1, 196, jcfg.motion_feature_dim)))
    jenc = JaxEncAdaptor(ch=ENC_CH)
    enc_p = _random_params(jenc.init, 3, 0.1, jnp.zeros((1, T, H, W, 3)))
    text, clip, mpm = td.stand_in_encoders(
        jcfg.text_dim, jcfg.clip_tokens, jcfg.clip_dim,
        jcfg.motion_feature_dim, H, W, jnp.asarray)

    drawn = []

    class Recording(JaxSampler):
        def __call__(self, rng, n, rank=0):
            idx = super().__call__(rng, n, rank)
            jax.debug.callback(lambda v: drawn.append(np.asarray(v)), idx)
            return idx

    out = str(tmp_path_factory.mktemp("jax_run"))
    mesh = create_mesh(MeshConfig(data=2, fsdp=4))
    orig = jax_train_straag.StratifiedTimestepSampler
    jax_train_straag.StratifiedTimestepSampler = Recording
    try:
        jt = JaxTrainer(JaxWanDiT(jcfg), dit_p, jvae, vae_p, jenc, enc_p,
                        text, mesh, JaxTrainConfig(**TCFG),
                        JaxRunConfig(output_dir=out, **dict(
                            RUN, checkpointing_steps=1000)),
                        encode_clip=clip, extract_mpm=mpm)
    finally:
        jax_train_straag.StratifiedTimestepSampler = orig
    key, draws, params = jax.random.PRNGKey(SEED), [], []
    shape = (BATCH, lt, lh, lw, 4)
    for step in range(STEPS):
        key, sub = jax.random.split(key)
        draws.append(_jax_draws(sub, shape))
        jt.run_cfg = JaxRunConfig(output_dir=out, **dict(
            RUN, max_steps=step + 1, checkpointing_steps=1000))
        jt.train(td.scene_batches((T, H, W), BATCH, step, JaxSample))
        params.append(jax.tree_util.tree_map(np.asarray, jt.params))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    tcfg = dit_tiny(dtype=torch.float32, **DIT)
    spec = dict(
        dit=DIT, vae=VAE, enc_ch=ENC_CH, sizes=(T, H, W), tcfg=TCFG, run=RUN,
        draws=draws,
        dit_state={k: v.numpy() for k, v in
                   dit_state_dict(dit_p, tcfg).items()},
        vae_state={k: v.numpy() for k, v in vae_state_dict(
            vae_p, VAEConfig(**VAE)).items()},
        enc_state={k: v.numpy() for k, v in
                   adaptor_state_dict(enc_p, decoder=False).items()})
    return dict(spec=spec, metrics=metrics, params=params,
                ema=jax.tree_util.tree_map(np.asarray, jt.ema),
                drawn=drawn, cfg=tcfg)


def _check_against_jax(jax_run, got, steps=range(STEPS)):
    """The port run's metrics lines (one a step, from step 1) and final
    params against JAX's."""
    want = {m["step"]: m for m in jax_run["metrics"]}
    for line in got["metrics"]:
        w = want[line["step"]]
        for key in ("train/loss", "train/grad_norm"):
            np.testing.assert_allclose(line[key], w[key], rtol=1e-5,
                                       err_msg=f"step {line['step']} {key}")
    assert sorted(m["step"] for m in got["metrics"]) == \
        [s + 1 for s in steps]
    final = dit_state_dict(jax_run["params"][-1], jax_run["cfg"])
    for name, w in final.items():
        err = np.abs(got["params"][name] - w.numpy()).max()
        assert err < 1e-5, f"params {name}: {err}"
    ema = dit_state_dict(jax_run["ema"], jax_run["cfg"])
    for name, w in ema.items():
        err = np.abs(got["ema"][name] - w.numpy()).max()
        assert err < 1e-5, f"ema {name}: {err}"


def _one_process(jax_run, out_dir, start, resume):
    """The port's trainer in this process (no mesh) from step ``start``."""
    from more4d_tpu_torch.train import harness

    orig = harness.draw
    try:
        trainer = td.build_straag_trainer(jax_run["spec"], None,
                                          str(out_dir), resume)
        trainer.train(td.scene_batches((T, H, W), BATCH, start,
                                       SceneFlowSample))
    finally:
        harness.draw = orig
    params = {k: v.detach().numpy() for k, v in
              trainer.dit.state_dict().items()}
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    return dict(metrics=metrics, params=params,
                ema={k: v.numpy() for k, v in trainer.ema.items()})


@pytest.fixture(scope="module")
def fsdp_run(jax_run, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp2")
    out = tmp / "out"
    ranks = td.spawn(td.straag_worker, 2, tmp, jax_run["spec"],
                     dict(data=1, fsdp=2), str(out), 0, False)
    return out, ranks[0]


def test_fsdp_steps_match_jax(jax_run, fsdp_run):
    """fsdp=2: every parameter sharded over the two ranks (JAX's rule,
    dim 0 where JAX replicates), two steps = JAX's on data=2 x fsdp=4."""
    _, got = fsdp_run
    assert all("Shard" in p for p in got["placements"].values())
    _check_against_jax(jax_run, got)


def test_two_rank_checkpoint_resumes_in_one_process(jax_run, fsdp_run,
                                                    tmp_path):
    """The fsdp=2 run's step-1 checkpoint, gathered whole by rank 0, loads
    in one process; its second step ends on the two-rank run's params."""
    out, two_rank = fsdp_run
    resumed = tmp_path / "resumed"
    shutil.copytree(out / "1", resumed / "1")
    got = _one_process(jax_run, resumed, 1, resume=True)
    assert [m["step"] for m in got["metrics"]] == [2]
    for name, w in two_rank["params"].items():
        assert np.abs(got["params"][name] - w).max() < 1e-6, name
    _check_against_jax(jax_run, got, steps=[1])


def test_one_process_checkpoint_resumes_on_data_parallel_mesh(jax_run,
                                                              tmp_path):
    """A one-process step-1 checkpoint resumes on data=2 (a row a rank,
    the gradients averaged over the two data shards); step 2 = JAX's."""
    first = tmp_path / "first"
    spec = dict(jax_run["spec"], run=dict(RUN, max_steps=1))
    one = dict(jax_run, spec=spec)
    step1 = _one_process(one, first, 0, resume=False)
    _check_against_jax_step1(jax_run, step1)
    ranks = td.spawn(td.straag_worker, 2, tmp_path, jax_run["spec"],
                     dict(data=2, fsdp=1), str(first), 1, True)
    got = ranks[0]
    got["metrics"] = [m for m in got["metrics"] if m["step"] == 2]
    _check_against_jax(jax_run, got, steps=[1])


def test_accumulation_on_the_mesh_matches_one_process(jax_run, tmp_path):
    """grad_accum_steps 2 on data=2: the running mean, the clamp on the
    mean and the one optimizer step of the window work on the mean over
    the data shards, as in one process (losses and grad norms 1e-5
    relative, params 1e-5); the step-1 checkpoint, taken inside the
    window, carries the sharded accumulator whole, and one process
    resumed from it ends on the two-rank run's params."""
    spec = dict(jax_run["spec"], tcfg=dict(TCFG, grad_accum_steps=2))
    one = _one_process(dict(jax_run, spec=spec), tmp_path / "one", 0,
                       resume=False)
    two = td.spawn(td.straag_worker, 2, tmp_path, spec,
                   dict(data=2, fsdp=1), str(tmp_path / "two"), 0,
                   False)[0]
    assert [m["step"] for m in two["metrics"]] == [1, 2]
    for g, w in zip(two["metrics"], one["metrics"]):
        assert (g["train/updated"], w["train/updated"]) == \
            ((0.0, 0.0) if g["step"] == 1 else (1.0, 1.0))
        for key in ("train/loss", "train/grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5)
    for name, w in one["params"].items():
        assert np.abs(two["params"][name] - w).max() < 1e-5, name
    shutil.copytree(tmp_path / "two" / "1", tmp_path / "resumed" / "1")
    resumed = _one_process(dict(jax_run, spec=spec), tmp_path / "resumed",
                           1, resume=True)
    for name, w in two["params"].items():
        assert np.abs(resumed["params"][name] - w).max() < 1e-6, name


def _check_against_jax_step1(jax_run, got):
    w = jax_run["metrics"][0]
    np.testing.assert_allclose(got["metrics"][0]["train/loss"],
                               w["train/loss"], rtol=1e-5)
    want = dit_state_dict(jax_run["params"][0], jax_run["cfg"])
    for name, p in want.items():
        assert np.abs(got["params"][name] - p.numpy()).max() < 1e-5, name


def test_sampler_rank_fault(jax_run):
    """JAX's harness (world_size 2, uniform sampling) draws every row from
    group 0's half; the port's draw stratifies each row by its data
    shard, and the two ranks' rows are the global draw's rows."""
    drawn = np.concatenate(jax_run["drawn"])
    assert drawn.size == BATCH * STEPS
    assert (drawn < 500).all() and (drawn >= 0).all()

    cfg = StraagTrainConfig(world_size=2)
    batch = {"latents": torch.zeros(4, 1, 2, 2, 4)}
    rows = []
    for rank in range(2):
        gen = torch.Generator().manual_seed(0)
        idx, noise = draw(cfg, batch, gen, rank=rank, shards=2)
        assert idx.shape == (4,) and noise.shape == (4, 1, 2, 2, 4)
        lo = 500 * rank
        assert ((idx >= lo) & (idx < lo + 500)).all(), (rank, idx)
        rows.append((idx, noise))
    gen = torch.Generator().manual_seed(0)
    whole = draw(cfg, {"latents": torch.zeros(8, 1, 2, 2, 4)}, gen,
                 rank=torch.arange(8) // 4)
    assert torch.equal(torch.cat([r[0] for r in rows]), whole[0])
    assert torch.equal(torch.cat([r[1] for r in rows]), whole[1])
