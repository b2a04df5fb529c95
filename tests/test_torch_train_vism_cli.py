"""The port's ViSM LoRA CLI (``more4d_tpu_torch/scripts/train_vism.py``)
on the CPU with tiny models, as ``tests/test_stage_clis.py`` drives the
JAX one: its flags against the JAX CLI's, ``prepare_vism_batch`` against
JAX's (the t2v zeroing included), the resident, ``--offload_blocks`` and
``--train_text_encoder`` loops with checkpoint and resume, the stride-2
frame alignment of ``load_vism_video`` (where ``cv2`` is installed), and
the exported kohya LoRA read back by the port's inference loader.

Tolerances: ``prepare_vism_batch`` to 1e-5 absolute (float32 VAE encodes
of the same weights); a resumed run's factors equal the uninterrupted
run's to 1e-6 (the same ops on the same inputs; the optimizer state, the
accumulation buffers and the generator come back from the checkpoint).
"""

import importlib.util
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_vism as tv
from more4d_tpu.config import VAEConfig as JaxVAEConfig
from more4d_tpu.data.vism import ViSMSample as JaxSample
from more4d_tpu.models.wan_vae import WanVAE as JaxVAE
from more4d_tpu_torch.config import VAEConfig
from more4d_tpu_torch.convert import vae_state_dict
from more4d_tpu_torch.data.vism import ViSMSample
from more4d_tpu_torch.models import WanVAE
from more4d_tpu_torch.scripts import train_vae as port_vae_cli
from more4d_tpu_torch.scripts import train_vism as cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
VAE = dict(dim=4, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
           temporal_downsample=(False, True, True))
INP = dict(in_dim=36, out_dim=16)       # the InP DiT on z_dim-16 latents
T, H, W = 5, 32, 32


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_cli_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv", [
    ("train_vism", ["--data_dir", "d", "--pretrained_ckpt", "p",
                    "--vae_ckpt", "v"]),
    ("train_vae", ["--video_list", "l", "--vae_ckpt", "v"]),
])
def test_flags_match_the_jax_cli(monkeypatch, name, argv):
    """Every flag of the JAX CLI, with its default, and no other."""
    jax_cli = _jax_script(name)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    want = vars(jax_cli.parse_args())
    port = cli if name == "train_vism" else port_vae_cli
    got = vars(port.build_parser().parse_args(argv))
    assert got == want


def test_unported_remat_policy_raises(vae_pair, tmp_path):
    """--remat_policy takes every JAX choice and no longer raises: two
    LoRA steps of the loop under 'flash' and 'dots' give the factors of
    'nothing' bit for bit (the merged weights reach the blocks' runs in
    the backward, which take K1's kept (o, lse) under 'flash'); an
    unknown policy still raises."""
    _, params = tv.jax_dit(**INP)
    port = vae_pair[2]
    factors = {}
    for policy in ("nothing", "flash", "dots"):
        dit = tv.port_dit(params, remat=True, remat_policy=policy, **INP)
        factors[policy] = _factors(cli.run_training(
            [dit], port, lambda p: torch.from_numpy(_encode_text(p)),
            _samples(), _args(tmp_path / policy, 2, remat_policy=policy),
            encode_clip=_encode_clip, device="cpu"))
    for policy in ("flash", "dots"):
        for n, f in factors["nothing"].items():
            for k, t in f.items():
                assert torch.equal(factors[policy][n][k], t), (policy, n)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--data_dir", "d",
                                       "--pretrained_ckpt", "p",
                                       "--vae_ckpt", "v", "--remat_policy",
                                       "flash_heavy"])


@pytest.fixture(scope="module")
def vae_pair():
    vae = JaxVAE(JaxVAEConfig(**VAE))
    vp = vae.init(jax.random.PRNGKey(0), jnp.zeros((1, T, H, W, 3)))
    port = WanVAE(VAEConfig(**VAE))
    port.load_state_dict(vae_state_dict(vp, port.cfg), strict=True)
    return vae, vp, port.requires_grad_(False)


def _sample(seed=0, keep=1.0):
    rs = np.random.RandomState(seed)
    mask = np.zeros((T, H, W, 3), np.float32)
    mask[:, : H // 2] = 1.0
    proj = rs.rand(T, H, W, 3).astype(np.float32) * 2 - 1
    return dict(pixel_values=rs.rand(T, H, W, 3).astype(np.float32) * 2 - 1,
                projected_images=proj, mask=mask,
                mask_pixel_values=proj * (1 - mask) - mask,
                clip_image01=rs.rand(H, W, 3).astype(np.float32),
                text="a room", t2v_keep_flag=keep)


def _port_sample(seed=0, keep=1.0):
    return ViSMSample(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                         else v for k, v in _sample(seed, keep).items()})


def _encode_clip(images):
    rs = np.random.RandomState(8)
    return torch.from_numpy(rs.randn(images.shape[0], 9, 16).astype(
        np.float32))


def _encode_text(prompts):
    rs = np.random.RandomState(9)
    vocab = rs.randn(32, 16).astype(np.float32)
    out = np.zeros((len(prompts), 8, 16), np.float32)
    for b, p in enumerate(prompts):
        for i, w in enumerate(p.split()[:8]):
            out[b, i] = vocab[sum(map(ord, w)) % 32]
    return out


@pytest.mark.parametrize("keep", [1.0, 0.0])
def test_prepare_vism_batch_matches_jax(vae_pair, keep):
    vae, vp, port = vae_pair
    jax_cli = _jax_script("train_vism")
    want = jax_cli.prepare_vism_batch(
        JaxSample(**_sample(keep=keep)), vae, vp,
        lambda p: jnp.asarray(_encode_text(p)), None)
    got = cli.prepare_vism_batch(_port_sample(keep=keep), port,
                                 lambda p: torch.from_numpy(_encode_text(p)),
                                 None)
    assert got["y"].shape[-1] == 4 + port.cfg.z_dim
    assert got["latents"].shape == got["y"].shape[:-1] + (port.cfg.z_dim,)
    for k in ("latents", "y", "context"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    if keep == 0.0:
        assert got["y"].abs().max().item() == 0.0     # the t2v flag
    else:
        assert got["y"].abs().max().item() > 0.0


def _args(out, steps, **over):
    """The CLI's arguments at its defaults, with these."""
    args = cli.build_parser().parse_args(
        ["--data_dir", str(out), "--pretrained_ckpt", "-", "--vae_ckpt",
         "-"])
    base = dict(learning_rate=1e-2, lora_rank=2, lora_alpha=2.0,
                output_dir=str(out), max_steps=steps, checkpointing_steps=2,
                log_steps=1, seed=0, export_kohya=True)
    for k, v in {**base, **over}.items():
        setattr(args, k, v)
    return args


def _samples(start=0):
    i = start
    while True:
        yield _port_sample(i)
        i += 1


def _factors(lora):
    if "factors" not in lora:
        return {p: _factors(v) for p, v in lora.items()}
    return {n: {k: t.detach().clone() for k, t in f.items()}
            for n, f in lora["factors"].items()}


def _assert_equal_factors(a, b):
    if "dit" in a:
        for p in a:
            _assert_equal_factors(a[p], b[p])
        return
    assert set(a) == set(b)
    for n in a:
        for k in a[n]:
            np.testing.assert_allclose(a[n][k].numpy(), b[n][k].numpy(),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["resident", "offload", "te",
                                  "came_accum"])
def test_loop_checkpoints_and_resumes(vae_pair, tmp_path, mode):
    """4 steps straight, against 2 steps then a resume for 2 more: the same
    factors. The factors move; the metrics hold every step's loss."""
    _, params = tv.jax_dit(**INP)
    port = vae_pair[2]
    over = {"offload": dict(offload_blocks=True),
            "te": dict(train_text_encoder=True),
            "came_accum": dict(optimizer="came", grad_accum_steps=2)
            }.get(mode, {})
    if mode == "te":
        _, te_params = tv.jax_t5()

        def tokenize(prompts):
            ids = np.zeros((len(prompts), 8), np.int64)
            for b, p in enumerate(prompts):
                for i, w in enumerate(p.split()):
                    ids[b, i] = sum(map(ord, w)) % 32
            mask = (ids > 0).astype(np.float32)
            return ids, mask

        def run(out, steps, samples, **more):
            return cli.run_training(
                [tv.port_dit(params, **INP)], port, None,
                samples, _args(out, steps, **over, **more), device="cpu",
                encode_clip=_encode_clip, text_encoder=tv.port_t5(te_params),
                tokenize=tokenize)
    else:
        def run(out, steps, samples, **more):
            return cli.run_training(
                [tv.port_dit(params, **INP)], port,
                lambda p: torch.from_numpy(_encode_text(p)), samples,
                _args(out, steps, **over, **more), encode_clip=_encode_clip,
                device="cpu")

    full = _factors(run(tmp_path / "a", 4, _samples()))
    lines = [json.loads(line) for line in
             open(os.path.join(tmp_path / "a", "metrics.jsonl"))]
    assert [r["step"] for r in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(r["train/loss"]) for r in lines)
    ups = [f["up"] for part in (full.values() if mode == "te" else [full])
           for f in part.values()]
    assert max(u.abs().max().item() for u in ups) > 0
    if mode == "came_accum":
        assert [r["train/updated"] for r in lines] == [0.0, 1.0, 0.0, 1.0]

    run(tmp_path / "b", 2, _samples())
    resumed = _factors(run(tmp_path / "b", 4, _samples(2), resume=True))
    _assert_equal_factors(resumed, full)


def test_offload_rejects_text_encoder_lora(vae_pair, tmp_path):
    _, params = tv.jax_dit(**INP)
    with pytest.raises(SystemExit, match="incompatible"):
        cli.run_training([tv.port_dit(params, **INP)],
                         vae_pair[2], None, _samples(),
                         _args(tmp_path, 1, offload_blocks=True,
                               train_text_encoder=True), device="cpu",
                         text_encoder=torch.nn.Linear(1, 1))


def test_exported_kohya_lora_loads_into_inference(vae_pair, tmp_path):
    """The kohya file a run exports, read by the inference CLI's loader
    (``convert/lora_torch.load_vism_lora``), gives the trained factors and
    merges into the InP DiT; the checkpoint directory reads the same."""
    from more4d_tpu_torch.convert.lora_torch import load_vism_lora
    from more4d_tpu_torch.train.lora import apply_lora

    _, params = tv.jax_dit(**INP)
    lora = cli.run_training(
        [tv.port_dit(params, **INP)], vae_pair[2],
        lambda p: torch.from_numpy(_encode_text(p)), _samples(),
        _args(tmp_path, 2), encode_clip=_encode_clip, device="cpu")
    for path in (os.path.join(tmp_path, "lora_kohya.safetensors"),
                 str(tmp_path)):
        loaded = load_vism_lora(path)
        assert loaded["rank"] == 2 and loaded["alpha"] == 2.0
        assert set(loaded["factors"]) == set(lora["factors"])
        for n, f in lora["factors"].items():
            for k in ("down", "up"):
                assert torch.equal(loaded["factors"][n][k],
                                   f[k].detach().float())
    base = tv.port_dit(params, **INP).state_dict()
    merged = apply_lora(base, loaded)
    changed = [k for k in base if not torch.equal(base[k], merged[k])]
    assert sorted(changed) == sorted(lora["factors"])


def test_load_vism_video_stride2_alignment(tmp_path):
    """The original clip is sampled as its renders are: stride 2 beyond
    the budget, last-frame padding below it."""
    pytest.importorskip("cv2")
    from more4d_tpu_torch.utils.artifacts import save_videos_grid

    src = np.stack([np.full((H, W, 3), i * 20, np.uint8)
                    for i in range(12)])
    path = str(tmp_path / "clip.mp4")
    save_videos_grid(path, src[None], fps=8)
    out = cli.load_vism_video(path, 5, (H, W))
    assert out.shape == (5, H, W, 3)
    np.testing.assert_allclose(out.mean(axis=(1, 2, 3)),
                               np.asarray([0, 2, 4, 6, 8]) * 20 / 255.0,
                               atol=0.04)
    out2 = cli.load_vism_video(path, 16, (H, W))
    assert out2.shape == (16, H, W, 3)
    np.testing.assert_allclose(out2[12:].mean(axis=(1, 2, 3)),
                               [11 * 20 / 255.0] * 4, atol=0.04)
