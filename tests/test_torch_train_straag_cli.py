"""The port's 4D-STraG training CLI (``more4d_tpu_torch/scripts/
train_straag.py``) on the CPU, as ``tests/test_train_harness.py`` drives
the JAX one: its flags against the JAX CLI's; the batch iterator against
the JAX CLI's (a corrupt pickle skipped; bucket mode resizing to the
closest bucket); ``main(argv, device="cpu")`` at a tiny size on
synthetic released-layout checkpoints: it trains, checkpoints, and a
resumed run goes on in the data order the checkpoint holds; a larger
``--mesh`` raises.

Tolerances: samples from the same pickles within 1e-6 (the two packages'
``prepare_straag_sample`` in float32). The bucket resize is
``F.interpolate(bilinear, align_corners=False)`` where the JAX CLI calls
``cv2.resize(INTER_LINEAR)``: the resized coordinates agree within 1e-5
(float32 interpolation weights; where ``cv2`` is missing the JAX side
cannot run and the test skips).
"""

import functools
import glob
import importlib.util
import json
import os
import pathlib
import pickle
import sys

import numpy as np
import pytest
import torch

from more4d_tpu_torch import config as tconfig
from more4d_tpu_torch.config import VAEConfig, dit_tiny
from more4d_tpu_torch.models import VAEEncoderAdaptor, WanDiT, WanVAE
from more4d_tpu_torch.scripts import train_straag as cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
T, H, W = 5, 32, 32
VAE = dict(dim=4, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
           temporal_downsample=(False, True, True))
FIELDS = ("flow", "first_frame_coords", "control_video", "first_frame_rgb",
          "depth_image")


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_cli_train_straag", ROOT / "scripts" / "train_straag.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REQUIRED = ["--data_dir", "d", "--pretrained_ckpt", "p", "--vae_ckpt", "v",
            "--encoder_adaptor", "e"]


@pytest.mark.parametrize("extra", [[], ["--remat_policy", "flash_offload",
                                        "--grad_accum_steps", "4",
                                        "--low_lr_names", "blocks",
                                        "--no-use_ema", "--split_step"]])
def test_flags_match_the_jax_cli(monkeypatch, extra):
    """Every flag of the JAX CLI, with its default (--model_size 14b
    included), and no other."""
    jax_cli = _jax_cli()
    monkeypatch.setattr(sys, "argv", ["train_straag"] + REQUIRED + extra)
    want = vars(jax_cli.parse_args())
    assert vars(cli.build_parser().parse_args(REQUIRED + extra)) == want
    assert want["model_size"] == "14b"


def _write_pickles(root, dims, seed=0):
    rs = np.random.RandomState(seed)
    for i, (sh, sw) in enumerate(dims):
        coords = (rs.rand(T, sh, sw, 3) * 3 + [0, 0, 1]).astype(np.float32)
        colors = (rs.rand(sh, sw, 3) * 255).astype(np.float32)
        with open(root / f"clip{i}_dt3d_pred.pkl", "wb") as f:
            pickle.dump({"coords": coords, "colors": colors}, f)
    return sorted(glob.glob(str(root / "*_dt3d_pred.pkl")))


def _assert_same_batches(got, want, atol):
    for (gs, gp), (ws, wp) in zip(got, want, strict=True):
        assert gp == wp
        for g, w in zip(gs, ws, strict=True):
            for field in FIELDS:
                np.testing.assert_allclose(getattr(g, field),
                                           getattr(w, field), rtol=0,
                                           atol=atol, err_msg=field)


def test_batch_iterator_skips_a_corrupt_pickle(tmp_path):
    files = _write_pickles(tmp_path, [(H, W)] * 4)
    with open(tmp_path / "bad_dt3d_pred.pkl", "wb") as f:
        f.write(b"not a pickle")
    files = sorted(glob.glob(str(tmp_path / "*_dt3d_pred.pkl")))
    assert len(files) == 5
    prompts = {os.path.splitext(os.path.basename(p))[0]: f"p{i}"
               for i, p in enumerate(files)}
    args = (files, prompts, iter(range(5)), 2, H, W, T)
    got = list(cli.make_batch_iterator(*args[:2], iter(range(5)),
                                       *args[3:]))
    want = list(_jax_cli().make_batch_iterator(*args))
    assert len(got) == 2 and [len(s) for s, _ in got] == [2, 2]
    assert got[0][0][0].flow.shape == (T, H, W, 3)
    _assert_same_batches(got, want, 1e-6)


def test_bucket_mode_resizes_as_the_jax_cv2_path(tmp_path):
    """Sources of three aspect ratios, none at a bucket's size: each is
    resized to its closest bucket (up and down) and batches gather per
    bucket, as the JAX CLI's cv2 path does."""
    pytest.importorskip("cv2")
    files = _write_pickles(tmp_path, [(40, 40), (20, 72), (24, 24),
                                      (18, 60), (56, 56), (12, 44)])
    buckets = [(16, 64), (H, W)]
    kw = dict(batch_size=2, height=H, width=W, num_frames=T,
              buckets=buckets)
    got = list(cli.make_batch_iterator(files, {}, iter(range(6)), **kw))
    want = list(_jax_cli().make_batch_iterator(files, {}, iter(range(6)),
                                               **kw))
    assert sorted(b[0][0].flow.shape for b in got) == [(T, 16, 64, 3),
                                                       (T, H, W, 3)]
    _assert_same_batches(got, want, 1e-5)


def test_resize_matches_cv2_inter_linear():
    cv2 = pytest.importorskip("cv2")
    x = np.random.RandomState(0).randn(3, 23, 37, 3).astype(np.float32)
    for h, w in [(16, 64), (46, 74), (12, 20)]:
        want = np.stack([cv2.resize(f, (w, h),
                                    interpolation=cv2.INTER_LINEAR)
                         for f in x])
        np.testing.assert_allclose(cli.resize_bilinear(x, h, w), want,
                                   rtol=0, atol=1e-5)


def test_a_larger_mesh_raises():
    with pytest.raises(NotImplementedError, match="Queue 1, item 5"):
        cli.main(REQUIRED + ["--mesh", "data=2,fsdp=4"], device="cpu")
    cli.check_mesh(None)
    cli.check_mesh("data=1,fsdp=-1")
    with pytest.raises(ValueError, match="mesh axis"):
        cli.check_mesh("model=1")


@pytest.fixture(scope="module")
def tiny_ckpts(tmp_path_factory):
    """A released-layout 3D Control DiT (48 input channels) at dit_tiny's
    width, the VAE under ``model.`` and an encoder adaptor, from seeds."""
    d = tmp_path_factory.mktemp("straag_ckpts")
    g = torch.Generator().manual_seed(0)
    dit = WanDiT(dit_tiny(motion_guidance=False, in_dim=48,
                          model_type="i2v")).init_weights(g)
    with torch.no_grad():
        dit.head.head.weight.normal_(0, 0.02, generator=g)
    torch.save(dit.state_dict(), d / "control.pth")
    vae = WanVAE(VAEConfig(**VAE)).init_weights(g)
    torch.save({"model." + k: v for k, v in vae.state_dict().items()},
               d / "vae.pth")
    enc = VAEEncoderAdaptor()
    with torch.no_grad():
        for p in enc.parameters():
            p.normal_(0, 0.05, generator=g)
    torch.save(enc.state_dict(), d / "enc.bin")
    return d


def test_main_trains_checkpoints_and_resumes_in_data_order(
        tiny_ckpts, tmp_path, monkeypatch):
    """``main`` at dit_tiny's width (``config.dit_1_3b`` and the VAE's
    widths patched to tiny ones) on 5 pickles: 2 steps, a checkpoint each
    step, then ``--resume`` for a third. The checkpoint holds the
    sampler's position; the resumed run reads on from that position of the
    sampler's order (the JAX CLI restores it only after its prefetch
    workers have drawn from position 0) and checkpoints step 3."""
    from more4d_tpu_torch.data import sceneflow

    monkeypatch.setattr(tconfig, "dit_1_3b", functools.partial(
        dit_tiny, dtype=torch.float32))
    monkeypatch.setattr(tconfig, "VAEConfig", lambda **kw: VAEConfig(
        **{**VAE, **kw}))
    data = tmp_path / "data"
    data.mkdir()
    files = _write_pickles(data, [(H, W)] * 5)
    read = []
    real = sceneflow.load_sceneflow_pickle

    def spy(path, height, width):
        read.append(files.index(path))
        return real(path, height, width)

    monkeypatch.setattr(sceneflow, "load_sceneflow_pickle", spy)
    out = tmp_path / "run"
    argv = ["--data_dir", str(data), "--pretrained_ckpt",
            str(tiny_ckpts / "control.pth"), "--vae_ckpt",
            str(tiny_ckpts / "vae.pth"), "--encoder_adaptor",
            str(tiny_ckpts / "enc.bin"), "--output_dir", str(out),
            "--model_size", "1.3b", "--allow_dummy_text", "--frozen_dtype",
            "fp32", "--height", str(H), "--width", str(W), "--num_frames",
            str(T), "--checkpointing_steps", "1", "--seed", "7",
            "--remat_policy", "flash_lite"]
    assert cli.main(argv + ["--max_steps", "2"], device="cpu") == 0
    extra = json.load(open(out / "2" / "extra.json"))
    assert extra["global_step"] == 2
    pos = extra["data"]
    order = np.random.RandomState(7 + pos["epoch"]).permutation(5)
    first_run = list(read)
    assert first_run[:2] == list(np.random.RandomState(7).permutation(5)[:2])
    read.clear()
    assert cli.main(argv + ["--max_steps", "3", "--resume"],
                    device="cpu") == 0
    assert read[0] == order[pos["pos_start"] % 5]
    assert sorted(os.listdir(out)) == ["2", "3", "metrics.jsonl"]
    assert json.load(open(out / "3" / "extra.json"))["global_step"] == 3
    lines = [json.loads(l) for l in open(out / "metrics.jsonl")]
    assert [l["step"] for l in lines] == [1]      # log_steps 50: step 1
    assert np.isfinite(lines[0]["train/loss"])
