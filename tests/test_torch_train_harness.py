"""The slice as a whole: the port's ``StraagTrainer`` against the JAX
``StraagTrainer`` at the tiny sizes of ``tests/test_train_harness.py``
(32x32, 5 frames, a tiny 4D-STraG DiT, VAE and encoder adaptor), with the
same converted weights and the same encoder stand-ins, on the CPU in fp32.

- ``prepare_batch``: the same numpy seed gives the same dropouts (control,
  text, CLIP) and the same batch. Tolerance: latents and y atol 1e-5 (the
  VAE encode of both packages in fp32 at magnitudes ~1, sums in other
  orders); context, CLIP and MPM features exact (the same stand-in
  arithmetic on the same arrays, times the same 0/1 dropouts).
- ``train()``: 3 steps write the metrics JSONL and a checkpoint; a run
  resumed from its step-2 checkpoint ends on the uninterrupted run's
  params, bit for bit (same ops on the same CPU, same draws: the
  checkpoint carries both generators).
- ``train()`` with gradient accumulation 2: params and EMA stay through
  the first micro-step, and the EMA takes one decay step when the window
  closes (atol 1e-6 on the EMA, fp32); ``trainable_filter`` with the
  grad-norm report (frozen params exactly still, one ``grad_norm/`` key a
  trainable tensor).
- Validation sampling writes its gif (where ``imageio`` is installed) and
  its video is the port pipeline's own output for the same generator,
  bit for bit.
- The MPM FiLM path receives gradient with real features and none with
  zeroed ones (the port's ``test_mpm_film_receives_gradient``).
- The scene-flow pickle loading and sample preparation match the JAX
  package's (tolerance in the test).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.config import VAEConfig as JaxVAEConfig
from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.data.sceneflow import SceneFlowSample as JaxSample
from more4d_tpu.models import WanDiT as JaxWanDiT
from more4d_tpu.models.adaptors import VAEEncoderAdaptor as JaxEncAdaptor
from more4d_tpu.models.wan_vae import WanVAE as JaxWanVAE
from more4d_tpu.parallel import MeshConfig, create_mesh
from more4d_tpu.train.harness import StraagRunConfig as JaxRunConfig
from more4d_tpu.train.harness import StraagTrainer as JaxTrainer
from more4d_tpu.train.train_straag import StraagTrainConfig as JaxTrainConfig
from more4d_tpu_torch.config import VAEConfig, dit_tiny
from more4d_tpu_torch.convert import (adaptor_state_dict, dit_state_dict,
                                      vae_state_dict)
from more4d_tpu_torch.data import SceneFlowSample
from more4d_tpu_torch.models import VAEEncoderAdaptor, WanDiT, WanVAE
from more4d_tpu_torch.train import (CheckpointManager, StraagRunConfig,
                                    StraagTrainConfig, StraagTrainer)

H, W, T = 32, 32, 5
VAE = dict(dim=4, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
           temporal_downsample=(False, True, True))
DIT = dict(in_dim=16, out_dim=4, motion_guidance=True, dim=32, ffn_dim=64,
           num_heads=2, num_layers=2, text_dim=16, clip_dim=16, text_len=8)
ENC_CH = 8
DROPOUT = dict(control_dropout=0.5, clip_dropout=0.5, text_dropout=0.5)


def _random_params(init, seed, std, *args, **kw):
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args, **kw)
    leaves, td = jax.tree_util.tree_flatten(shapes)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        td, [np.asarray(rs.normal(0, std, l.shape), np.float32)
             for l in leaves])


def _encoders(dcfg, to):
    """Deterministic stand-ins with the towers' call signatures, returning
    ``to(numpy array)`` (jnp or torch)."""
    rs = np.random.RandomState(7)
    vocab = rs.randn(64, dcfg.text_dim).astype(np.float32)
    wc = rs.randn(3, dcfg.clip_dim).astype(np.float32)
    wm = rs.randn(3, dcfg.motion_feature_dim).astype(np.float32)

    def encode_text(prompts):
        out = np.zeros((len(prompts), 8, dcfg.text_dim), np.float32)
        for i, p in enumerate(prompts):
            for j, word in enumerate(p.split()[:8]):
                out[i, j] = vocab[len(word) * 7 % 64]
        return to(out)

    def encode_clip(images):
        pooled = np.asarray(images, np.float32).mean(axis=(1, 2)) @ wc
        return to(np.ascontiguousarray(np.broadcast_to(
            pooled[:, None], (len(pooled), dcfg.clip_tokens,
                              dcfg.clip_dim))))

    def extract_mpm(images01):
        x = np.asarray(images01, np.float32)[:, ::H // 14 or 1][:, :14]
        x = x[:, :, ::W // 14 or 1][:, :, :14]
        return to(x.reshape(len(x), 196, 3) @ wm)

    return encode_text, encode_clip, extract_mpm


def _sample(seed, cls):
    rs = np.random.RandomState(seed)
    flow = rs.randn(T, H, W, 3).astype(np.float32) * 0.1
    rgb = rs.rand(H, W, 3).astype(np.float32)
    return cls(flow=flow,
               first_frame_coords=rs.rand(H, W, 3).astype(np.float32),
               control_video=np.repeat((rgb * 2 - 1)[None], T, 0),
               first_frame_rgb=rgb,
               depth_image=rs.rand(1, H, W, 3).astype(np.float32) * 2 - 1)


@pytest.fixture(scope="module")
def weights():
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
    return jcfg, jvae, vae_p, dit_p, jenc, enc_p


def _port_trainer(weights, run_cfg, tcfg=None, **kw):
    jcfg, _, vae_p, dit_p, _, enc_p = weights
    cfg = dit_tiny(dtype=torch.float32, **DIT)
    dit = WanDiT(cfg)
    dit.load_state_dict(dit_state_dict(dit_p, cfg), strict=True)
    vae = WanVAE(VAEConfig(**VAE))
    vae.load_state_dict(vae_state_dict(vae_p, vae.cfg), strict=True)
    enc = VAEEncoderAdaptor(ch=ENC_CH)
    enc.load_state_dict(adaptor_state_dict(enc_p, decoder=False),
                        strict=True)
    text, clip, mpm = _encoders(cfg, torch.from_numpy)
    return StraagTrainer(
        dit, vae, enc, text,
        tcfg or StraagTrainConfig(learning_rate=1e-4,
                                  abnormal_loss_threshold=1e9),
        run_cfg, encode_clip=clip, extract_mpm=mpm, **kw)


def test_prepare_batch_matches_jax(weights):
    jcfg, jvae, vae_p, dit_p, jenc, enc_p = weights
    text, clip, mpm = _encoders(jcfg, jnp.asarray)
    jt = JaxTrainer(JaxWanDiT(jcfg), dit_p, jvae, vae_p, jenc, enc_p, text,
                    create_mesh(MeshConfig(data=1, fsdp=-1, seq=1)),
                    JaxTrainConfig(), JaxRunConfig(seed=3, **DROPOUT),
                    encode_clip=clip, extract_mpm=mpm)
    pt = _port_trainer(weights, StraagRunConfig(seed=3, **DROPOUT))
    prompts = ["a cat moves left", "the camera pans"]
    dropped = 0
    for call in range(2):
        seeds = (2 * call, 2 * call + 1)
        want = jt.prepare_batch([_sample(s, JaxSample) for s in seeds],
                                prompts)
        got = pt.prepare_batch([_sample(s, SceneFlowSample) for s in seeds],
                               prompts)
        assert set(got) == set(want) == {"latents", "y", "context",
                                         "clip_fea", "mpm_features"}
        for name, w in want.items():
            w = np.asarray(w)
            g = got[name].numpy()
            assert g.shape == w.shape, name
            atol = 1e-5 if name in ("latents", "y") else 0
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=name)
        ctrl = got["y"][..., :4].flatten(1).abs().amax(1)
        dropped += int((ctrl == 0).sum()) + int(
            (got["clip_fea"].flatten(1).abs().amax(1) == 0).sum())
    assert dropped > 0, "the seed exercised no dropout"


def _batches(start=0):
    i = start
    while True:
        yield [_sample(100 + i, SceneFlowSample)], ["a scene moves"]
        i += 1


def test_train_writes_metrics_checkpoints_and_resumes(weights, tmp_path):
    full = _port_trainer(weights, StraagRunConfig(
        output_dir=str(tmp_path / "full"), max_steps=3,
        checkpointing_steps=3, log_steps=1, seed=0))
    before = {n: p.detach().clone() for n, p in full.dit.named_parameters()}
    timings = []
    full.train(_batches(), extra_state=lambda: {"pos": 3}, timings=timings)
    assert full.global_step == 3 and len(timings) == 3
    lines = [json.loads(l) for l in
             open(tmp_path / "full" / "metrics.jsonl")]
    losses = [l["train/loss"] for l in lines]
    assert len(losses) == 3 and all(np.isfinite(losses))
    mgr = CheckpointManager(str(tmp_path / "full"))
    assert mgr.latest_step() == 3
    assert mgr.restore(with_extra=True)["extra"] == {"global_step": 3,
                                                     "data": {"pos": 3}}
    ema = mgr.restore_params(item="ema")
    moved = max((full.dit.state_dict()[n] - before[n]).abs().max().item()
                for n in before)
    assert moved > 0
    assert all(torch.equal(ema[n], full.ema[n]) for n in ema)

    # two steps, a checkpoint, then a fresh trainer resumes for the third
    pos = {"pos": 0}
    cut = _port_trainer(weights, StraagRunConfig(
        output_dir=str(tmp_path / "cut"), max_steps=2,
        checkpointing_steps=2, log_steps=1, seed=0))
    cut.train(_batches(), extra_state=lambda: {"pos": 2})
    resumed = _port_trainer(weights, StraagRunConfig(
        output_dir=str(tmp_path / "cut"), max_steps=3,
        checkpointing_steps=100, log_steps=1, seed=0, resume=True))
    resumed.train((b for b in _batches(start=2)),
                  restore_state=pos.update)
    assert resumed.global_step == 3 and pos == {"pos": 2}
    for name, p in full.dit.state_dict().items():
        torch.testing.assert_close(resumed.dit.state_dict()[name], p,
                                   rtol=0, atol=0, msg=name)
    for name, e in full.ema.items():
        torch.testing.assert_close(resumed.ema[name], e, rtol=0, atol=0)


def test_checkpoint_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((2,), float(step))},
                 extra={"global_step": step})
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]
    assert mgr.restore_params()["w"][0].item() == 3.0
    assert mgr.restore_params(step=2)["w"][0].item() == 2.0


def test_validation_is_not_ported(weights, tmp_path, monkeypatch):
    """Validation sampling, once ported: at validation_steps the trainer
    samples from the batch's first sample through its validation pipeline
    (20-step Euler here cut to 2), logs ``validation_written`` and writes
    ``validation_<step>.gif``, and the video is the pipeline's own output
    for a generator seeded with the run's seed, mapped to [0, 1]."""
    from more4d_tpu_torch.config import PipelineConfig
    from more4d_tpu_torch.pipelines import WanControlPipeline
    from more4d_tpu_torch.utils import artifacts

    trainer = _port_trainer(weights, StraagRunConfig(
        output_dir=str(tmp_path), max_steps=1, checkpointing_steps=100,
        log_steps=1, seed=5, validation_steps=1, **DROPOUT))
    pipe = WanControlPipeline(trainer.dit, trainer.vae, PipelineConfig(
        num_frames=T, height=H, width=W, num_inference_steps=2),
        device="cpu")
    trainer.validation_pipeline = pipe
    written = {}
    real_save = artifacts.save_videos_grid

    def save(path, video, **kw):
        written[os.path.basename(path)] = video
        try:
            import imageio  # noqa: F401
        except ImportError:
            return
        real_save(path, video, **kw)

    monkeypatch.setattr(artifacts, "save_videos_grid", save)
    batches = _batches()
    sample = _sample(100, SceneFlowSample)
    trainer.train(batches)
    assert set(written) == {"validation_1.gif"}
    video = written["validation_1.gif"]
    text, clip, mpm = _encoders(trainer.dit.cfg, torch.from_numpy)
    rgb01 = torch.from_numpy(sample.first_frame_rgb)[None]
    want = pipe(torch.Generator().manual_seed(5),
                text(["a scene moves"]), neg_embeds=text([""]),
                control_video=torch.from_numpy(sample.control_video)[None],
                depth_image=torch.from_numpy(sample.depth_image)[None],
                clip_fea=clip(rgb01 * 2 - 1), mpm_features=mpm(rgb01),
                output_type="no_normalize")
    assert video.shape == (1, T, H, W, 3)
    np.testing.assert_array_equal(
        video, ((want + 1) * 0.5).clamp(0, 1).numpy())
    lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert any(l.get("validation_written") == 1.0 for l in lines)
    if os.path.exists(tmp_path / "validation_1.gif"):
        assert os.path.getsize(tmp_path / "validation_1.gif") > 0


def test_grad_accumulation_through_train(weights, tmp_path):
    """grad_accum_steps 2 through ``train()``: the clamp moves onto the
    mean (clip_in_tx); after the first micro-step params and EMA are the
    start's, bit for bit; after the second the params moved and the EMA
    took exactly one decay step, ema = d ema0 + (1 - d) params."""
    trainer = _port_trainer(
        weights, StraagRunConfig(output_dir=str(tmp_path), max_steps=1,
                                 checkpointing_steps=100, log_steps=1,
                                 seed=0),
        StraagTrainConfig(learning_rate=1e-3, abnormal_loss_threshold=1e9,
                          ema_decay=0.5, grad_accum_steps=2))
    assert trainer.tcfg.clip_in_tx
    start = {n: p.detach().clone() for n, p in trainer.dit.named_parameters()}
    ema0 = {n: e.clone() for n, e in trainer.ema.items()}
    trainer.train(_batches())
    for n, p in trainer.dit.named_parameters():
        assert torch.equal(p, start[n]) and torch.equal(trainer.ema[n],
                                                        ema0[n]), n
    trainer.run_cfg.max_steps = 2
    trainer.train(_batches(1))
    moved = max((p - start[n]).abs().max().item()
                for n, p in trainer.dit.named_parameters())
    assert moved > 0
    for n, p in trainer.dit.named_parameters():
        torch.testing.assert_close(trainer.ema[n],
                                   0.5 * ema0[n] + 0.5 * p.detach(),
                                   rtol=0, atol=1e-6)
    lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert [l["train/updated"] for l in lines] == [0.0, 1.0]


def test_trainable_filter_and_grad_norm_report(weights, tmp_path):
    """trainable_filter freezes the rest (exactly still over 2 steps);
    report_grad_norms logs one ``grad_norm/<name>`` a trainable tensor on
    each log step, none for a frozen one."""
    trainer = _port_trainer(
        weights, StraagRunConfig(output_dir=str(tmp_path), max_steps=2,
                                 checkpointing_steps=100, log_steps=1,
                                 seed=0, text_dropout=0.0,
                                 control_dropout=0.0),
        StraagTrainConfig(learning_rate=1e-3, abnormal_loss_threshold=1e9,
                          use_ema=False),
        trainable_filter=lambda name: "head" in name,
        report_grad_norms=True)
    start = {n: p.detach().clone() for n, p in trainer.dit.named_parameters()}
    trainer.train(_batches())
    for n, p in trainer.dit.named_parameters():
        assert torch.equal(p, start[n]) != ("head" in n), n
    lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    reports = [{k[len("grad_norm/"):]: v for k, v in l.items()
                if k.startswith("grad_norm/")} for l in lines]
    reports = [r for r in reports if r]
    assert [l["step"] for l in lines if "train/loss" in l] == [1, 2]
    assert len(reports) == 2
    for r in reports:
        assert set(r) == {n for n in start if "head" in n}
        assert all(np.isfinite(v) and v > 0 for v in r.values())


def test_mpm_film_receives_gradient(weights):
    """With real MPM features the FiLM projections and the feature
    adapter get gradient; with zeroed features the adapter's first conv
    kernel gets exactly none."""
    trainer = _port_trainer(weights, StraagRunConfig(
        seed=0, text_dropout=0.0, control_dropout=0.0, clip_dropout=0.0))
    batch = trainer.prepare_batch([_sample(3, SceneFlowSample)],
                                  ["a dog runs"])
    dit = trainer.dit
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if "spatial_guidance" in name and name.endswith("gate"):
                p.fill_(0.1)

    def film_grads(mpm):
        dit.zero_grad(set_to_none=True)
        pred = dit(batch["latents"] * 0.9, torch.full((1,), 500.0),
                   batch["context"], y=batch["y"], clip_fea=batch["clip_fea"],
                   mpm_features=mpm)
        pred.square().mean().backward()
        grads = dict(dit.named_parameters())
        film = sum(p.grad.abs().sum().item() for n, p in grads.items()
                   if "spatial_guide" in n and n.endswith("weight"))
        return film, grads["feature_adapter.0.weight"].grad.abs().sum().item()

    film_real, adapter_real = film_grads(batch["mpm_features"])
    _, adapter_zero = film_grads(torch.zeros_like(batch["mpm_features"]))
    assert film_real > 1e-8, "FiLM projection got no gradient"
    assert adapter_real > 1e-8, "MPM features do not reach the grad path"
    assert adapter_zero == 0.0


@pytest.mark.parametrize("normalize", ["depth", "minmax", "track_z"])
def test_sceneflow_preparation_matches_jax(normalize, tmp_path):
    """The port's pickle loading and sample preparation (normalisation,
    frame pad and cut, control video, depth image, large-depth filter)
    against the JAX package's: fp32, atol 1e-6 at magnitudes ~1. The
    depth normalisation inverts exactly (atol 1e-5 at depths 1-4)."""
    import pickle

    from more4d_tpu.data.sceneflow import load_sceneflow_pickle as jax_load
    from more4d_tpu.data.sceneflow import prepare_straag_sample as jax_prep
    from more4d_tpu_torch.data import (load_sceneflow_pickle,
                                       prepare_straag_sample)
    from more4d_tpu_torch.geometry import (inverse_normalize_with_depth,
                                           normalize_with_depth)

    rs = np.random.RandomState(0)
    coords = (rs.rand(T, H * W, 3) * 3 + [0, 0, 1]).astype(np.float32)
    path = tmp_path / "clip_dt3d_pred.pkl"
    with open(path, "wb") as f:
        pickle.dump({"coords": coords,
                     "colors": (rs.rand(H * W, 3) * 255).astype(np.float32)},
                    f)
    c, colors = load_sceneflow_pickle(str(path), H, W)
    jc, jcolors = jax_load(str(path), H, W)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(colors, jcolors)
    for frames in (3, 9):
        got = prepare_straag_sample(c, colors, frames, normalize)
        want = jax_prep(c, colors, frames, normalize)
        for field in ("flow", "first_frame_coords", "control_video",
                      "first_frame_rgb", "depth_image"):
            np.testing.assert_allclose(getattr(got, field),
                                       getattr(want, field), rtol=0,
                                       atol=1e-6, err_msg=field)
    far = c * 200.0
    assert prepare_straag_sample(far, colors, 9, normalize) is None
    assert jax_prep(far, colors, 9, normalize) is None
    if normalize == "depth":
        ct = torch.from_numpy(c)[None]
        back = inverse_normalize_with_depth(normalize_with_depth(ct),
                                            ct[:, 0])
        torch.testing.assert_close(back, ct, rtol=0, atol=1e-5)
