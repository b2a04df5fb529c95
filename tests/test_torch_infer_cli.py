"""The port's CLIs on the CPU at tiny size, on synthetic checkpoints in the
released key layout (written by the port's modules; the DiTs as released
3D checkpoints, the Control one with 48 input channels).

``more4d_tpu_torch.scripts.infer.main(argv, device="cpu")`` runs the flags
of ``tests/test_infer_cli.py::test_infer_cli_end_to_end`` and writes the
files the JAX CLI writes (named by the JAX package's trajectory names);
the stage gating, batch mode, both multistep samplers and every unported
flag; ``run_sample`` resumed from saved clouds inpaints what a whole run
does; the memory modes run on a mesh of two gloo ranks as in one process.
``infer_vae``'s round trip agrees with the JAX script's on the same
weights (relative 1e-4, the VAE's tolerance); ``check_wan`` and
``check_unidepth`` (its ``--run_compare`` too) report as the JAX scripts
do.
"""

import json
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.config import VAEConfig as JaxVAEConfig
from more4d_tpu.geometry.cameras import TRAJECTORY_TYPES as JAX_TRAJECTORIES
from more4d_tpu.models.adaptors import VAEDecoderAdaptor as JaxDecAdaptor
from more4d_tpu.models.adaptors import VAEEncoderAdaptor as JaxEncAdaptor
from more4d_tpu.models.wan_vae import WanVAE as JaxWanVAE
from more4d_tpu_torch import convert
from more4d_tpu_torch.config import VAEConfig, dit_tiny
from more4d_tpu_torch.infer import two_stage
from more4d_tpu_torch.models import (UniDepthV2, VAEDecoderAdaptor,
                                     VAEEncoderAdaptor, WanDiT, WanVAE)
from more4d_tpu_torch.scripts import check_unidepth, check_wan, infer
from more4d_tpu_torch.scripts import infer_vae
from more4d_tpu_torch.utils import load_pointcloud_txt, save_videos_grid
from more4d_tpu_torch.utils.safetensors_io import save_file

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

H = W = 32
FRAMES = 5
VAE_TINY = dict(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
                temporal_downsample=(False, True, True))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These small models run faster on one thread than on threads that
    the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_ckpts")
    g = torch.Generator().manual_seed(0)
    for name, in_dim in (("control", 48), ("inp", 36)):
        dit = WanDiT(dit_tiny(motion_guidance=False, in_dim=in_dim,
                              model_type="i2v")).init_weights(g)
        with torch.no_grad():
            dit.head.head.weight.normal_(0, 0.02, generator=g)
        torch.save(dit.state_dict(), d / f"{name}.pth")
    vae = WanVAE(VAEConfig(**VAE_TINY)).init_weights(g)
    torch.save({"model." + k: v for k, v in vae.state_dict().items()},
               d / "vae.pth")
    torch.save(VAEDecoderAdaptor(ch=64).state_dict(), d / "dec.bin")
    rs = np.random.RandomState(7)
    lora = {}
    for b in range(2):
        for mod, (o, i) in {"self_attn_q": (128, 128),
                            "ffn_0": (256, 128)}.items():
            base = f"lora_unet_blocks_{b}_{mod}"
            lora[base + ".lora_down.weight"] = torch.from_numpy(
                rs.randn(2, i).astype(np.float32) * 0.05)
            lora[base + ".lora_up.weight"] = torch.from_numpy(
                rs.randn(o, 2).astype(np.float32) * 0.05)
            lora[base + ".alpha"] = torch.tensor(2.0)
    torch.save(lora, d / "stage1_lora.pth")
    save_file(lora, str(d / "vism_lora.safetensors"))
    return d


def image(path, seed=0):
    from PIL import Image

    arr = (np.random.RandomState(seed).rand(H, W, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
    return str(path)


def base_argv(ckpt_dir, out_dir, *extra):
    return ["--control_ckpt", str(ckpt_dir / "control.pth"),
            "--inp_ckpt", str(ckpt_dir / "inp.pth"),
            "--vae_ckpt", str(ckpt_dir / "vae.pth"),
            "--decoder_adaptor", str(ckpt_dir / "dec.bin"),
            "--output_dir", str(out_dir), "--model_size", "tiny",
            "--adaptor_ch", "64", "--allow_dummy_text",
            "--height", str(H), "--width", str(W),
            "--num_frames", str(FRAMES), "--num_inference_steps", "2",
            "--depth_provider", "constant", *extra]


def jax_cli_files(name, traj_spec):
    """The files the JAX CLI writes for one image with stage 2: its clouds
    and one video a trajectory, named as the JAX package's
    ``render_trajectories`` names them (base name and sweep index)."""
    picked = []
    for tok in traj_spec.split(","):
        ts = ([JAX_TRAJECTORIES[int(tok)]] if tok.isdigit() else
              [t for t in JAX_TRAJECTORIES if t[0] == tok])
        picked += [t for t in ts if t not in picked]
    videos = [f"{name}_{t[0]}_{JAX_TRAJECTORIES.index(t)}.mp4"
              for t in picked]
    return sorted([f"{name}_coords.npy", f"{name}_colors.npy",
                   f"{name}_frame0.txt"] + videos)


def test_cli_end_to_end_writes_the_jax_cli_files(tmp_path, ckpt_dir,
                                                 monkeypatch):
    seen = {}
    make = two_stage.make_two_stage_models

    def spy(*a, **k):
        m = make(*a, **k)
        seen["models"] = m
        return m

    monkeypatch.setattr(two_stage, "make_two_stage_models", spy)
    out = tmp_path / "out"
    infer.main(["--image", image(tmp_path / "img.png"),
                "--prompt", "a tiny smoke test",
                *base_argv(ckpt_dir, out, "--stage2_batch", "2",
                           "--trajectories", "static,1,3",
                           "--stage1_lora", str(ckpt_dir / "stage1_lora.pth"),
                           "--vism_lora", str(ckpt_dir /
                                              "vism_lora.safetensors"),
                           "--stage2_num_inference_steps", "3",
                           "--stage2_guidance_scale", "5.5",
                           "--stage2_negative_prompt", "blurry")],
               device="cpu")
    m = seen["models"]
    assert m.inpaint_pipeline.config.num_inference_steps == 3
    assert m.inpaint_pipeline.config.guidance_scale == 5.5
    assert m.control_pipeline.config.num_inference_steps == 2
    assert m.control_pipeline.dit.patch_embedding.weight.dtype == \
        torch.bfloat16
    assert m.control_pipeline.dit.cfg.in_dim == 64
    assert sorted(os.listdir(out)) == jax_cli_files("img", "static,1,3")
    coords = np.load(out / "img_coords.npy")
    assert coords.shape == (FRAMES, H * W, 3) and np.isfinite(coords).all()
    cloud, colors = load_pointcloud_txt(str(out / "img_frame0.txt"))
    np.testing.assert_allclose(cloud, coords[0], atol=1e-5)
    np.testing.assert_allclose(colors, np.load(out / "img_colors.npy"),
                               atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("sampler,knobs,cls", [
    ("flow_dpm++", ["--solver_order", "3", "--solver_type", "heun"],
     "FlowDPMScheduler"),
    ("flow_unipc", ["--solver_type", "bh1", "--solver_thresholding"],
     "FlowUniPCScheduler")])
def test_cli_multistep_samplers(tmp_path, ckpt_dir, monkeypatch, sampler,
                                knobs, cls):
    seen = {}
    make = two_stage.make_two_stage_models
    monkeypatch.setattr(two_stage, "make_two_stage_models",
                        lambda *a, **k: seen.setdefault("m", make(*a, **k)))
    out = tmp_path / "out"
    infer.main(["--image", image(tmp_path / "img.png", 5), "--prompt", "x",
                *base_argv(ckpt_dir, out, "--num_inference_steps", "3",
                           "--trajectories", "static", "--sampler", sampler,
                           "--teacache_threshold", "0.5",
                           "--no-run_stage2_complete", *knobs)],
               device="cpu")
    m = seen["m"]
    sched = m.control_pipeline.scheduler
    assert type(sched).__name__ == cls and sched.num_steps == 3
    assert m.inpaint_pipeline is None
    assert np.isfinite(np.load(out / "img_coords.npy")).all()


def test_cli_stage_gating_resume(tmp_path, ckpt_dir):
    out = tmp_path / "out"
    argv = ["--image", image(tmp_path / "img.png", 1), "--prompt", "x",
            *base_argv(ckpt_dir, out, "--trajectories", "0",
                       "--mixed_precision", "fp32")]
    infer.main(argv + ["--no-run_stage2_complete"], device="cpu")
    wrote = sorted(os.listdir(out))
    assert wrote == sorted(["img_coords.npy", "img_colors.npy",
                            "img_frame0.txt", "img_static_0_render.mp4",
                            "img_static_0_mask.mp4"])
    infer.main(argv + ["--only_render"], device="cpu")
    assert "img_static_0.mp4" in os.listdir(out)


def test_resumed_sample_inpaints_as_a_whole_run(tmp_path, ckpt_dir):
    """The generator gives stage 2's seed before stage 1's noise, so a run
    resumed from the saved clouds inpaints exactly what the whole run
    did."""
    args = infer.build_parser().parse_args(
        ["--image", "unused", "--prompt", "x",
         *base_argv(ckpt_dir, tmp_path, "--trajectories", "2",
                    "--mixed_precision", "fp32")])
    models = infer.load_models(args, "cpu")
    img = np.random.RandomState(2).rand(H, W, 3).astype(np.float32)
    whole = infer.run_sample(models, img, "x", args,
                             torch.Generator().manual_seed(3))
    clouds = (whole["coords"].numpy(), whole["colors"].numpy())
    resumed = infer.run_sample(models, None, "x", args,
                               torch.Generator().manual_seed(3), clouds)
    assert set(whole["timings"]) == {"stage1_s", "render_s", "stage2_s"}
    assert [v["name"] for v in resumed["videos"]] == ["forward_backward_2"]
    for a, b in zip(whole["videos"], resumed["videos"]):
        assert a["video"].shape == (FRAMES, H, W, 3)
        assert torch.equal(a["video"], b["video"])


def test_cli_batch_mode(tmp_path, ckpt_dir):
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    image(img_dir / "a.png", 0)
    image(img_dir / "c.png", 1)
    save_videos_grid(str(img_dir / "b.mp4"), np.random.RandomState(7).rand(
        4, H, W, 3).astype(np.float32)[None], fps=8)
    (tmp_path / "prompts.json").write_text(json.dumps({"a": "specific"}))
    out = tmp_path / "out"
    infer.main(["--image_dir", str(img_dir), "--prompts_json",
                str(tmp_path / "prompts.json"), "--prompt", "fallback",
                "--max_samples", "2",
                *base_argv(ckpt_dir, out, "--trajectories", "0",
                           "--no-run_stage2_complete")], device="cpu")
    wrote = sorted(os.listdir(out))
    for name in ("a", "b"):
        assert f"{name}_coords.npy" in wrote
        assert f"{name}_static_0_render.mp4" in wrote
    assert not any(f.startswith("c_") for f in wrote)


# the memory modes, stage 2's options and the mesh flags are ported:
# refuse_unported lets them through (test_memory_mode_flags_run and
# test_mesh_flags_on_a_world_of_one run them)
PORTED = ("--fp8_weights", "--offload_blocks", "--teacache_offload",
          "--stage2_denoise_group", "--no-stage2_shared_noise", "--fsdp",
          "--sp", "--sweep_dp")


@pytest.mark.parametrize("flag", [
    ["--fp8_weights"], ["--offload_blocks"], ["--teacache_offload"],
    ["--fsdp"], ["--sp", "2"], ["--sweep_dp"],
    ["--stage2_denoise_group", "1"], ["--no-stage2_shared_noise"],
    ["--depth_provider", "unidepth"], ["orbax"]])
def test_unported_flags_raise(tmp_path, ckpt_dir, flag):
    argv = ["--image", "x.png", "--prompt", "p",
            *base_argv(ckpt_dir, tmp_path / "out")]
    if flag[0] in PORTED:
        infer.refuse_unported(infer.build_parser().parse_args(argv + flag))
        return
    if flag == ["orbax"]:
        os.makedirs(tmp_path / "orbax" / "10" / "params")
        argv[argv.index("--control_ckpt") + 1] = str(tmp_path / "orbax")
        argv[0:2] = ["--image", image(tmp_path / "img.png")]
        flag = []
    with pytest.raises(NotImplementedError, match="ROADMAP|orbax"):
        infer.main(argv + flag, device="cpu")


@pytest.mark.parametrize("flags", [
    ["--fp8_weights"], ["--offload_blocks"], ["--teacache_offload"],
    ["--stage2_denoise_group", "1"], ["--no-stage2_shared_noise"]],
    ids=["fp8_weights", "offload_blocks", "teacache_offload",
         "stage2_denoise_group", "no_stage2_shared_noise"])
def test_memory_mode_flags_run(tmp_path, ckpt_dir, monkeypatch, flags):
    """The memory modes and stage 2's options at tiny size, two
    trajectories in one stage-2 chunk, with the ViSM LoRA merged first."""
    seen = {}
    make = two_stage.make_two_stage_models
    monkeypatch.setattr(two_stage, "make_two_stage_models",
                        lambda *a, **k: seen.setdefault("m", make(*a, **k)))
    out = tmp_path / "out"
    infer.main(["--image", image(tmp_path / "img.png", 3), "--prompt", "x",
                *base_argv(ckpt_dir, out, "--trajectories", "static,1",
                           "--stage2_batch", "2", "--vism_lora",
                           str(ckpt_dir / "vism_lora.safetensors"),
                           *flags)], device="cpu")
    assert sorted(os.listdir(out)) == jax_cli_files("img", "static,1")
    m = seen["m"]
    pipes = (m.control_pipeline, m.inpaint_pipeline)
    q = m.inpaint_pipeline.dit.blocks[0].self_attn.q.weight.dtype \
        if flags[0] != "--offload_blocks" else None
    assert (q == torch.float8_e4m3fn) == (flags[0] == "--fp8_weights")
    streamed = [p.streamed_dit is not None for p in pipes]
    assert streamed == [flags[0] == "--offload_blocks"] * 2
    if flags[0] == "--offload_blocks":
        host = m.inpaint_pipeline.streamed_dit.host_blocks
        assert len(host) == 2 and len(m.inpaint_pipeline.dit.blocks) == 0
        assert host[0].tensors["ffn.0.weight"].dtype == torch.float8_e4m3fn
    assert all(p.teacache.offload_residual == (flags[0] ==
                                               "--teacache_offload")
               for p in pipes)


def test_mesh_flags_on_a_world_of_one(tmp_path, ckpt_dir, capsys):
    """``--fsdp --sweep_dp`` in one process: a world of one on gloo, the
    DiTs wrapped by FSDP2, the JAX CLI's warning and the serial sweep;
    the files and stage-1 clouds of the run without the flags, bit for
    bit. ``--offload_blocks`` with ``--fsdp`` passes ``refuse_unported``
    on two ranks and runs in a world of one: the resident parts wrapped
    by FSDP2, the blocks streamed, the files and clouds of the run with
    ``--offload_blocks`` alone, bit for bit."""
    import torch.distributed as dist

    img = image(tmp_path / "img.png", 3)
    argv = ["--image", img, "--prompt", "x", "--trajectories", "static,1"]
    infer.main(argv + base_argv(ckpt_dir, tmp_path / "plain"), device="cpu")
    try:
        infer.main(argv + base_argv(ckpt_dir, tmp_path / "mesh", "--fsdp",
                                    "--sweep_dp"), device="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert "falling back to the serial sweep" in capsys.readouterr().out
    want = sorted(os.listdir(tmp_path / "plain"))
    assert sorted(os.listdir(tmp_path / "mesh")) == want
    np.testing.assert_array_equal(np.load(tmp_path / "mesh" / "img_coords.npy"),
                                  np.load(tmp_path / "plain" / "img_coords.npy"))
    args = infer.build_parser().parse_args(
        argv + base_argv(ckpt_dir, tmp_path) + ["--fsdp", "--offload_blocks"])
    os.environ["WORLD_SIZE"] = "2"
    try:
        infer.refuse_unported(args)
    finally:
        del os.environ["WORLD_SIZE"]
    seen = []
    load = infer.load_models
    infer.main(argv + base_argv(ckpt_dir, tmp_path / "off",
                                "--offload_blocks"), device="cpu")
    try:
        infer.load_models = lambda *a, **k: seen.append(load(*a, **k)) \
            or seen[-1]
        infer.main(argv + base_argv(ckpt_dir, tmp_path / "off_mesh",
                                    "--fsdp", "--offload_blocks"),
                   device="cpu")
    finally:
        infer.load_models = load
        if dist.is_initialized():
            dist.destroy_process_group()
    from more4d_tpu_torch.parallel.mesh import is_sharded

    pipes = (seen[0].control_pipeline, seen[0].inpaint_pipeline)
    assert all(is_sharded(p.dit) and p.streamed_dit is not None
               for p in pipes)
    assert sorted(os.listdir(tmp_path / "off_mesh")) == want
    np.testing.assert_array_equal(
        np.load(tmp_path / "off_mesh" / "img_coords.npy"),
        np.load(tmp_path / "off" / "img_coords.npy"))


def test_sp_and_sweep_dp_on_two_ranks(tmp_path, ckpt_dir):
    """``--sp 2 --sweep_dp`` on two gloo ranks: Ulysses in both DiTs, the
    sweep a trajectory a rank, rank 0 writing the one-process run's files;
    its stage-1 clouds within 1e-4 of the one-process run's (fp32, the
    sequence split sums the products in other blocks; 3.3e-6 measured at
    magnitudes up to 4.6)."""
    import _torch_dist as td

    img = image(tmp_path / "img.png", 3)
    argv = ["--image", img, "--prompt", "x", "--trajectories", "static,1"]
    infer.main(argv + base_argv(ckpt_dir, tmp_path / "one"), device="cpu")
    ranks = td.spawn(td.infer_cli_worker, 2, tmp_path,
                     argv + base_argv(ckpt_dir, tmp_path / "two", "--sp",
                                      "2", "--sweep_dp"))
    want = sorted(os.listdir(tmp_path / "one"))
    assert ranks[0]["files"] == want == jax_cli_files("img", "static,1")
    one = np.load(tmp_path / "one" / "img_coords.npy")
    np.testing.assert_allclose(ranks[0]["coords"], one, atol=1e-4, rtol=0)


def test_fsdp_on_two_ranks(tmp_path, ckpt_dir):
    """``--fsdp`` on two gloo ranks: both DiTs sharded over fsdp=2 (no seq
    split), every pipeline call gathering the shards through FSDP2's
    forward methods; rank 0 writes the one-process run's files and its
    stage-1 clouds agree with the one-process run's within 1e-4 (fp32, as
    the test above)."""
    import _torch_dist as td

    img = image(tmp_path / "img.png", 3)
    argv = ["--image", img, "--prompt", "x", "--trajectories", "static,1"]
    infer.main(argv + base_argv(ckpt_dir, tmp_path / "one"), device="cpu")
    ranks = td.spawn(td.infer_cli_worker, 2, tmp_path,
                     argv + base_argv(ckpt_dir, tmp_path / "two", "--fsdp"))
    want = sorted(os.listdir(tmp_path / "one"))
    assert ranks[0]["files"] == want == jax_cli_files("img", "static,1")
    assert ranks[0]["fsdp"] == 2 and ranks[0]["sharded"]
    one = np.load(tmp_path / "one" / "img_coords.npy")
    np.testing.assert_allclose(ranks[0]["coords"], one, atol=1e-4, rtol=0)


MESH_MEMORY_MODES = {
    "fsdp_fp8": ("--fsdp", "--fp8_weights"),
    "fsdp_offload": ("--fsdp", "--offload_blocks"),
    "sp2_fp8": ("--sp", "2", "--fp8_weights"),
    "sp2_offload": ("--sp", "2", "--offload_blocks"),
}


@pytest.mark.parametrize("mode", list(MESH_MEMORY_MODES))
def test_memory_modes_on_two_ranks(tmp_path, ckpt_dir, mode):
    """The memory modes on a mesh of two gloo ranks, as the JAX CLI runs
    them: ``--fp8_weights`` quantizes each DiT, then shards it (each
    rank's shards still fp8, half of the bytes under ``--fsdp``; whole
    under ``--sp 2``, whose fsdp axis is 1); ``--offload_blocks`` shards
    the resident part (no block left on it) and streams the whole blocks,
    fp8 on the host, on each rank. Under ``--sp 2`` every block runs on
    the rank's half of the tokens. Rank 0 writes the files of the one-process run in the
    same memory mode, and its stage-1 clouds agree with that run's
    within 1e-4 (fp32 compute, as ``test_fsdp_on_two_ranks``)."""
    import _torch_dist as td

    flags = MESH_MEMORY_MODES[mode]
    memory = flags[-1]
    img = image(tmp_path / "img.png", 3)
    argv = ["--image", img, "--prompt", "x", "--trajectories", "static,1"]
    infer.main(argv + base_argv(ckpt_dir, tmp_path / "one", memory),
               device="cpu")
    ranks = td.spawn(td.infer_cli_worker, 2, tmp_path,
                     argv + base_argv(ckpt_dir, tmp_path / "two", *flags))
    want = sorted(os.listdir(tmp_path / "one"))
    assert ranks[0]["files"] == want == jax_cli_files("img", "static,1")
    fsdp = 2 if flags[0] == "--fsdp" else 1
    tokens = ((FRAMES - 1) // 4 + 1) * (H // 16) * (W // 16)
    for r in ranks:
        assert r["block_tokens"] == [tokens // 2 if fsdp == 1 else tokens]
        for d in r["dits"]:
            assert d["sharded"] and d["all_dtensors"] and d["fsdp"] == fsdp
            if memory == "--fp8_weights":
                assert d["fp8_local_dtypes"] == ["torch.float8_e4m3fn"]
                assert d["fp8_bytes"] and \
                    d["fp8_local_bytes"] * fsdp == d["fp8_bytes"]
                assert d["host_blocks"] is None and d["blocks"] == 2
            else:
                assert d["blocks"] == 0 and d["fp8_bytes"] == 0
                assert d["host_blocks"] == ["torch.float8_e4m3fn"] * 2
    one = np.load(tmp_path / "one" / "img_coords.npy")
    np.testing.assert_allclose(ranks[0]["coords"], one, atol=1e-4, rtol=0)


def test_cli_refusals_match_jax(tmp_path, ckpt_dir):
    argv = base_argv(ckpt_dir, tmp_path / "out")
    with pytest.raises(SystemExit, match="exactly one"):
        infer.main(argv, device="cpu")
    with pytest.raises(SystemExit, match="--prompt is required"):
        infer.main(["--image", "x.png", *argv], device="cpu")
    img = image(tmp_path / "img.png")
    no_text = [a for a in argv if a != "--allow_dummy_text"]
    with pytest.raises(ValueError, match="no umT5"):
        infer.main(["--image", img, "--prompt", "x", *no_text], device="cpu")
    depth = argv[:argv.index("--depth_provider")]
    with pytest.raises(SystemExit, match="--depth_ckpt"):
        infer.main(["--image", img, "--prompt", "x", *depth], device="cpu")
    with pytest.raises(SystemExit, match="unknown trajectory"):
        infer.main(["--image", img, "--prompt", "x", *argv,
                    "--trajectories", "nowhere"], device="cpu")


# ------------------------------------------------------------- infer_vae

class Jitted:
    """A flax module whose ``apply`` is jitted (the JAX script calls
    ``module.apply``; op by op it spends its time compiling each op)."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply, static_argnames=("method", "clip"))


def test_infer_vae_roundtrip_matches_jax(tmp_path, capsys):
    from infer_vae import evaluate as jax_evaluate

    t, hw = 5, 8
    vae_cfg = dict(VAE_TINY, dim=4, z_dim=4)
    jvae = JaxWanVAE(JaxVAEConfig(**vae_cfg))
    dummy = jnp.zeros((1, t, hw, hw, 3), jnp.float32)
    rs = np.random.RandomState(0)

    def rand(module):
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), dummy)
        return jax.tree_util.tree_map(
            lambda l: np.asarray(rs.normal(0, 0.1, l.shape), np.float32),
            shapes)

    jenc, jdec = JaxEncAdaptor(ch=16), JaxDecAdaptor(ch=16)
    vp, ep, dp = rand(jvae), rand(jenc), rand(jdec)
    vae = WanVAE(VAEConfig(**vae_cfg))
    vae.load_state_dict(convert.vae_state_dict(vp, VAEConfig(**vae_cfg)))
    enc, dec = VAEEncoderAdaptor(ch=16), VAEDecoderAdaptor(ch=16)
    enc.load_state_dict(convert.adaptor_state_dict(ep, decoder=False))
    dec.load_state_dict(convert.adaptor_state_dict(dp, decoder=True))
    flows = [np.random.RandomState(i).randn(t, hw, hw, 3).astype(
        np.float32) * 0.1 for i in range(3)]

    def samples():
        return ((f"s{i}", f) for i, f in enumerate(flows))

    args = types.SimpleNamespace(output_dir=str(tmp_path / "j"),
                                 max_samples=2)
    want = jax_evaluate(Jitted(jvae), vp, Jitted(jenc), ep, Jitted(jdec), dp,
                        samples(), args)
    args.output_dir = str(tmp_path / "t")
    got = infer_vae.evaluate(vae.eval(), enc.eval(), dec.eval(), samples(),
                             args)
    assert got["extra"]["n"] == want["extra"]["n"] == 2
    np.testing.assert_allclose(got["value"], want["value"], rtol=1e-4)
    for k in ("l1", "rmse"):
        np.testing.assert_allclose(got["extra"][k], want["extra"][k],
                                   rtol=1e-4)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "unit"] == "mean-EPE"


def test_infer_vae_main_on_sceneflow_pickles(tmp_path):
    """The whole script on the first of two scene-flow pickles (5 frames
    of 32x32), with the full-width VAE and adaptors from their checkpoints
    and the side-by-side videos: K4's (the CPU runs its plain version) and
    the z-buffer projection's."""
    g = torch.Generator().manual_seed(0)
    torch.save(WanVAE(VAEConfig()).init_weights(g).state_dict(),
               tmp_path / "vae.pth")
    torch.save(VAEEncoderAdaptor().state_dict(), tmp_path / "enc.bin")
    torch.save(VAEDecoderAdaptor().state_dict(), tmp_path / "dec.bin")
    os.makedirs(tmp_path / "dt3d")
    rs = np.random.RandomState(0)
    for name in ("a", "b"):
        coords = rs.rand(5, 32 * 32, 3).astype(np.float32) + [0, 0, 2]
        with open(tmp_path / "dt3d" / f"{name}_dt3d_pred.pkl", "wb") as f:
            pickle.dump({"coords": coords,
                         "colors": rs.rand(32 * 32, 3)}, f)
    (tmp_path / "list.txt").write_text("videos/a.mp4\nvideos/b.mp4\n")
    argv = ["--video_list", str(tmp_path / "list.txt"),
            "--vae_ckpt", str(tmp_path / "vae.pth"),
            "--encoder_adaptor", str(tmp_path / "enc.bin"),
            "--decoder_adaptor", str(tmp_path / "dec.bin"),
            "--output_dir", str(tmp_path / "eval"), "--num_frames", "5",
            "--height", "32", "--width", "32", "--normalize", "delta",
            "--max_samples", "1"]
    assert infer_vae.main(argv + ["--save_videos", "--render_type", "3dgs"],
                          device="cpu") == 0
    wrote = sorted(os.listdir(tmp_path / "eval"))
    assert wrote == ["a_dt3d_pred_roundtrip_gs.mp4", "vae_eval.jsonl"]
    # the default --render_type project: the z-buffer projection
    assert infer_vae.main(argv + ["--save_videos"], device="cpu") == 0
    assert "a_dt3d_pred_roundtrip.mp4" in os.listdir(tmp_path / "eval")


# ------------------------------------------------------------ the checks

def test_check_wan(tmp_path, ckpt_dir, capsys):
    flags = ["--model_size", "tiny", "--variant", "control4d",
             "--num_layers", "2"]
    sd = torch.load(ckpt_dir / "control.pth", weights_only=True)
    # the tiny DiT's image projection reads 1280 channels here, as the
    # reference's does at any size
    g = torch.Generator().manual_seed(1)
    for k in ("img_emb.proj.0.weight", "img_emb.proj.0.bias",
              "img_emb.proj.1.bias"):
        sd[k] = torch.randn(1280, generator=g)
    sd["img_emb.proj.1.weight"] = torch.randn(1280, 1280, generator=g)
    sd["img_emb.proj.3.weight"] = torch.randn(128, 1280, generator=g)
    good = str(tmp_path / "good.safetensors")
    save_file(sd, good)
    assert check_wan.main([good] + flags) == 0
    out = capsys.readouterr().out
    assert "OK" in out and "surgery" in out and "fresh-init" in out
    sd["time_projection.1.weight_X"] = sd.pop("time_projection.1.weight")
    torch.save(sd, tmp_path / "bad.pth")
    assert check_wan.main([str(tmp_path / "bad.pth")] + flags) == 1
    out = capsys.readouterr().out
    assert "time_projection.1.weight" in out and "FAILED" in out


def _transformers_dinov2_names(sd, depth):
    """A UniDepth state dict with its backbone under ``transformers``'
    ``Dinov2Model`` names (q, k and v split), the inverse of the port's
    ``dinov2.official_names``."""
    out = {k: v for k, v in sd.items() if not k.startswith("pixel_encoder.")}
    enc = {k[len("pixel_encoder."):]: v for k, v in sd.items()
           if k.startswith("pixel_encoder.")}
    names = {"patch_embed.proj": "embeddings.patch_embeddings.projection",
             "norm": "layernorm"}
    for k, v in enc.items():
        if k in ("cls_token", "pos_embed", "mask_token"):
            out["pixel_encoder.embeddings." + {
                "cls_token": "cls_token", "pos_embed":
                "position_embeddings", "mask_token": "mask_token"}[k]] = v
            continue
        mod, leaf = k.rsplit(".", 1)
        if mod in names:
            out[f"pixel_encoder.{names[mod]}.{leaf}"] = v
            continue
        _, i, rest = mod.split(".", 2)
        t = f"pixel_encoder.encoder.layer.{i}"
        if rest == "attn.qkv":
            for n, part in zip(("query", "key", "value"), v.chunk(3)):
                out[f"{t}.attention.attention.{n}.{leaf}"] = part
        elif rest in ("ls1", "ls2"):
            out[f"{t}.layer_scale{rest[-1]}.lambda1"] = v
        else:
            rest = {"attn.proj": "attention.output.dense"}.get(rest, rest)
            out[f"{t}.{rest}.{leaf}"] = v
    assert len(out) == len(sd) + 4 * depth      # qkv in three
    return out


def test_check_unidepth(tmp_path, capsys, monkeypatch):
    """The strict load's OK and FAILED, as the JAX script reports them;
    ``--run_compare`` prints COMPARE OK and returns 0 on the tiny
    checkpoint: decoder only under the official DINOv2 names (they do not
    fit ``transformers``' names), the whole graph against
    ``Dinov2Model`` under its names (tol 1e-2, the JAX script's); a
    planted divergence in the port's depth head (its log-depth plus 0.1)
    prints COMPARE FAILED and returns 1."""
    from more4d_tpu_torch.models import unidepth as tunidepth

    geo = ["--backbone_dim", "32", "--backbone_depth", "2",
           "--backbone_heads", "2", "--hidden_dim", "32", "--layer_ids",
           "0,1", "--num_adapters", "2"]
    model = UniDepthV2(backbone_dim=32, backbone_depth=2, backbone_heads=2,
                       hidden_dim=32, layer_ids=(0, 1)).init_weights(
        torch.Generator().manual_seed(0))
    sd = {**model.state_dict(), "pixel_encoder.mask_token": torch.zeros(1)}
    torch.save({"state_dict": sd}, tmp_path / "ud.pth")
    assert check_unidepth.main([str(tmp_path / "ud.pth")] + geo) == 0
    assert "OK" in capsys.readouterr().out
    bad = dict(sd)
    bad["camera_head.proj.weight_Y"] = bad.pop("camera_head.proj.weight")
    torch.save(bad, tmp_path / "bad.pth")
    assert check_unidepth.main([str(tmp_path / "bad.pth")] + geo) == 1
    out = capsys.readouterr().out
    assert "camera_head.proj.weight" in out and "FAILED" in out

    compare = [str(tmp_path / "ud.pth"), "--run_compare"] + geo
    assert check_unidepth.main(compare) == 0
    out = capsys.readouterr().out
    assert "DECODER ONLY" in out and "COMPARE OK" in out
    hf = _transformers_dinov2_names(sd, 2)
    # a released transformers checkpoint's mask token is [1, dim]
    hf["pixel_encoder.embeddings.mask_token"] = torch.zeros(1, 32)
    torch.save(hf, tmp_path / "hf.pth")
    assert check_unidepth.main([str(tmp_path / "hf.pth"), "--run_compare"]
                               + geo) == 0
    out = capsys.readouterr().out
    assert "FULL GRAPH" in out and "COMPARE OK" in out, out

    head = tunidepth.DepthHead.forward
    monkeypatch.setattr(tunidepth.DepthHead, "forward",
                        lambda self, *a: head(self, *a) + 0.1)
    assert check_unidepth.main(compare) == 1
    assert "COMPARE FAILED" in capsys.readouterr().out


def test_artifacts_and_profiling_match_jax(tmp_path, capsys):
    """The port's copy of ``utils/artifacts.py`` writes what the JAX one
    writes; ``utils/profiling`` times and traces a block."""
    from more4d_tpu.utils import artifacts as jart
    from more4d_tpu_torch.utils import artifacts as tart
    from more4d_tpu_torch.utils.profiling import timer, trace

    rs = np.random.RandomState(0)
    videos = rs.rand(3, 2, 16, 16, 3).astype(np.float32)
    np.testing.assert_array_equal(tart.make_grid(videos, 2),
                                  jart.make_grid(videos, 2))
    coords, colors = rs.randn(9, 3).astype(np.float32), rs.rand(9, 3)
    tart.save_pointcloud_txt(str(tmp_path / "t.txt"),
                             torch.from_numpy(coords), colors)
    jart.save_pointcloud_txt(str(tmp_path / "j.txt"), coords, colors)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    tart.save_videos_grid(str(tmp_path / "v.mp4"), torch.from_numpy(videos))
    np.testing.assert_array_equal(
        tart.read_video_frames(str(tmp_path / "v.mp4")),
        jart.read_video_frames(str(tmp_path / "v.mp4")))
    np.testing.assert_array_equal(
        tart.read_mask_video(str(tmp_path / "v.mp4")),
        jart.read_mask_video(str(tmp_path / "v.mp4")))

    @timer("unit")
    def f(x):
        return (x * 2).sum()

    assert f(torch.ones(8, 8)).item() == 128.0
    assert "[timer] unit:" in capsys.readouterr().out
    with trace(str(tmp_path / "trace")):
        torch.ones(4, 4).sum()
    assert os.listdir(tmp_path / "trace")
