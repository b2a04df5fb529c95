"""Two-stage inference CLI: single image -> 4D novel-view videos (PyTorch
port of ``scripts/infer.py``, with its flags and defaults).

    python -m more4d_tpu_torch.scripts.infer \\
      --image cat.png --prompt "a cat turns its head" \\
      --control_ckpt /ckpts/Wan2.1-Fun-V1.1-1.3B-Control \\
      --inp_ckpt /ckpts/Wan2.1-Fun-V1.1-1.3B-InP \\
      --vae_ckpt /ckpts/Wan2.1_VAE.pth \\
      --t5_ckpt /ckpts/models_t5_umt5-xxl-enc-bf16.pth \\
      --clip_ckpt /ckpts/models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth \\
      --omnimae_ckpt /ckpts/omnimae.pth --depth_ckpt /ckpts/unidepth_v2.pth \\
      --decoder_adaptor /ckpts/decoder_prompt.bin \\
      --vism_lora /ckpts/vism_lora.safetensors --model_size 1.3b \\
      --output_dir out/

Checkpoints: a DiT as a directory of ``diffusion_pytorch_model*
.safetensors`` shards, one ``.safetensors`` or a ``.pth``; the VAE as
``.pth`` or ``.safetensors``; LoRAs in kohya format; the towers as torch
files; or a checkpoint directory of the port's own trainers. A JAX command
line runs unchanged: ``--depth_provider unidepth_jax`` (the default) is
the port's own UniDepth (``unidepth_native``). A flag whose module is not
ported raises ``NotImplementedError`` naming its ``ROADMAP.md`` item; none
is ignored.

The same ``--seed`` gives other noise than the JAX CLI: noise comes from a
``torch.Generator`` (seeded with ``--seed``, plus the sample's index in
``--image_dir`` mode) where the JAX CLI splits ``PRNGKey(seed)``.

On several cards, one process a card:

    torchrun --nproc_per_node=4 -m more4d_tpu_torch.scripts.infer ... \
      --sp 4              # Ulysses: each rank 1/4 of the tokens
      --fsdp              # the DiTs' weights sharded over the ranks
      --sweep_dp          # stage 2's trajectories split over the ranks

``--fsdp`` and ``--sp`` build the JAX CLI's mesh (every rank on ``fsdp``
but the ``seq`` ranks); rank 0 writes the files. Either combines with
``--fp8_weights`` (the fp8 DiTs sharded) or ``--offload_blocks`` (the
resident parts sharded, the blocks streamed on each rank from a pinned
copy of its own: N ranks on one host pin N copies).

``main(argv, device)`` is the program; ``load_models`` and ``run_sample``
are its two halves, for callers that load once and sample many times.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device

VIDEO_EXTS = (".mp4", ".avi", ".mkv", ".webm", ".mov")
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m more4d_tpu_torch.scripts.infer",
        description="single image -> 4D novel-view videos")
    p.add_argument("--image", default=None)
    p.add_argument("--prompt", default=None)
    p.add_argument("--image_dir", default=None,
                   help="batch mode: every image (or video: its first "
                        "frame) in this directory")
    p.add_argument("--prompts_json", default=None,
                   help="batch mode: {image_basename: prompt}; --prompt is "
                        "the shared fallback")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--control_ckpt", required=True)
    p.add_argument("--inp_ckpt", required=True)
    p.add_argument("--vae_ckpt", required=True)
    p.add_argument("--t5_ckpt", default=None)
    p.add_argument("--allow_dummy_text", action="store_true",
                   help="run without a T5 checkpoint (zero text "
                        "conditioning - smoke tests only)")
    p.add_argument("--tokenizer", default="google/umt5-xxl")
    p.add_argument("--clip_ckpt", default=None)
    p.add_argument("--omnimae_ckpt", default=None)
    p.add_argument("--decoder_adaptor", required=True)
    p.add_argument("--vism_lora", default=None,
                   help="kohya .safetensors/.pth, or a checkpoint directory "
                        "of the port's trainers")
    p.add_argument("--lora_weight", type=float, default=0.55)
    p.add_argument("--stage1_lora", default=None)
    p.add_argument("--stage1_lora_weight", type=float, default=0.55)
    p.add_argument("--use_ema_params", action="store_true",
                   help="from a checkpoint directory of the port's "
                        "trainers, load the EMA weights")
    p.add_argument("--output_dir", default="out")
    p.add_argument("--height", type=int, default=368)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num_frames", type=int, default=49)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=6.0)
    p.add_argument("--stage2_guidance_scale", type=float, default=None)
    p.add_argument("--stage2_num_inference_steps", type=int, default=None)
    p.add_argument("--stage2_negative_prompt", default=None)
    p.add_argument("--shift", type=float, default=3.0)
    p.add_argument("--sampler", default="flow",
                   choices=["flow", "flow_unipc", "flow_dpm++"])
    p.add_argument("--solver_order", type=int, default=None,
                   choices=[1, 2, 3])
    p.add_argument("--solver_type", default=None,
                   help="dpm++: midpoint|heun; unipc: bh1|bh2")
    p.add_argument("--solver_algorithm", default=None,
                   choices=["dpmsolver++", "dpmsolver", "sde-dpmsolver++",
                            "sde-dpmsolver"],
                   help="flow_dpm++ only (algorithm_type)")
    p.add_argument("--solver_thresholding", action="store_true",
                   help="dynamic thresholding of the x0 prediction")
    p.add_argument("--teacache_threshold", type=float, default=0.10)
    p.add_argument("--teacache_offload", action="store_true")
    p.add_argument("--cfg_skip_ratio", type=float, default=0.0)
    p.add_argument("--riflex_k", type=int, default=None)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of each sample here")
    p.add_argument("--mixed_precision", default="bf16",
                   choices=["bf16", "fp32"])
    p.add_argument("--fp8_weights", action="store_true")
    p.add_argument("--offload_blocks", action="store_true")
    p.add_argument("--stage2_batch", type=int, default=1,
                   help="trajectories per batched stage-2 call (1 = the "
                        "reference's serial sweep)")
    p.add_argument("--stage2_denoise_group", type=int, default=None)
    p.add_argument("--stage2_shared_noise",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--sweep_dp", action="store_true")
    p.add_argument("--use_depth", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="--no-use_depth runs stage 1 with the 48-channel "
                        "Control DiT (no depth conditioning)")
    p.add_argument("--depth_provider", default="unidepth_jax",
                   choices=["unidepth", "unidepth_jax", "precomputed",
                            "constant"])
    p.add_argument("--depth_dir", default=None)
    p.add_argument("--depth_ckpt", default=None,
                   help="UniDepth-V2 torch checkpoint")
    p.add_argument("--use_gs", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--trajectories", default=None,
                   help="subset of the 11-trajectory sweep: comma-separated "
                        "indices (0-10) and/or base names")
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--num_skip_start_steps", type=int, default=5)
    p.add_argument("--normalize_track_z", action="store_true")
    p.add_argument("--run_stage1", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="--no-run_stage1 (or --only_render) loads "
                        "{image}_coords.npy/_colors.npy from --output_dir")
    p.add_argument("--only_render", action="store_true")
    p.add_argument("--run_stage2_complete",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--save_renders", action="store_true")
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--model_size", default="14b",
                   choices=["14b", "1.3b", "tiny"])
    p.add_argument("--adaptor_ch", type=int, default=128)
    return p


def refuse_unported(args) -> None:
    """Raise NotImplementedError for a flag whose module is not ported."""
    unported = [
        (args.depth_provider == "unidepth", "--depth_provider unidepth",
         "Ground truth (the third-party unidepth package is not in the "
         "repository; --depth_provider unidepth_jax is the port's own)"),
    ]
    for on, flag, item in unported:
        if on:
            raise NotImplementedError(f"{flag} is not ported (ROADMAP.md "
                                      f"{item})")


def pick_trajectories(spec: Optional[str]):
    """--trajectories -> a list of trajectory types (None: the whole
    sweep); unknown names, indices out of range and empty selections
    exit."""
    from ..geometry.cameras import TRAJECTORY_TYPES

    if not spec:
        return None
    picked = []
    for tok in (t.strip() for t in spec.split(",")):
        if not tok:
            continue
        if tok.isdigit():
            idx = int(tok)
            if idx >= len(TRAJECTORY_TYPES):
                raise SystemExit(f"trajectory index {idx} out of range "
                                 f"0-{len(TRAJECTORY_TYPES) - 1}")
            picked.append(TRAJECTORY_TYPES[idx])
        else:
            match = [t for t in TRAJECTORY_TYPES if t[0] == tok]
            if not match:
                names = sorted({t[0] for t in TRAJECTORY_TYPES})
                raise SystemExit(f"unknown trajectory {tok!r}; names: "
                                 f"{', '.join(names)}")
            picked.extend(match)
    if not picked:
        raise SystemExit(f"--trajectories {spec!r} selects nothing")
    out = []
    for t in picked:      # a name and its index may overlap: keep order
        if t not in out:
            out.append(t)
    return out


def load_models(args, device="cuda", timings: Optional[dict] = None):
    """The CLI's models from its checkpoint flags: the DiTs with their
    LoRAs merged in float32 before the cast to ``--mixed_precision``, the
    VAE (patched by a fine-tuned decoder the adaptor checkpoint carries),
    the decoder adaptor, the towers, the depth provider and TeaCache, as
    ``TwoStageModels`` on ``device``. The DiT of a stage that does not run
    is not loaded. ``timings`` receives each load's wall seconds.

    The memory modes (``parallel.placement.place_dit``): ``--fp8_weights``
    stores each DiT's large matrices in fp8 on the card (unscaled, after
    the cast); ``--offload_blocks`` keeps each DiT's blocks in pinned host
    memory in fp8 and its resident part on the card (``StreamedDiT``),
    each DiT offloaded as soon as it is loaded, so host memory holds one
    DiT's wide copy at a time; ``--teacache_offload`` parks TeaCache's
    residual in pinned host memory. Under ``--fsdp``/``--sp`` the DiT, or
    under ``--offload_blocks`` its resident part, is sharded over the
    mesh after its memory mode is applied; each rank pins its own copy of
    the blocks."""
    from ..config import PipelineConfig, VAEConfig, dit_1_3b, dit_14b, \
        dit_tiny
    from ..convert.dit_torch import load_wan_dit
    from ..convert.lora_torch import load_vism_lora
    from ..convert.vae_torch import load_wan_vae
    from ..infer.encoders import build_encoders, build_tokenize
    from ..infer.two_stage import make_two_stage_models
    from ..models.adaptors import VAEDecoderAdaptor, load_adaptor
    from ..models.depth import get_depth_provider
    from ..models.wan_dit import WanDiT
    from ..models.wan_vae import WanVAE
    from ..nn.layers import from_state_dict
    from ..parallel import set_mesh
    from ..parallel.offload import StreamedDiT
    from ..parallel.placement import place_dit
    from ..pipelines import TEACACHE_COEFFICIENTS, TeaCacheConfig
    from ..train.lora import merge_lora_
    from ..utils.profiling import host_memory_gib

    dev = resolve_device(device)
    refuse_unported(args)
    timings = {} if timings is None else timings
    print("host memory: " + ", ".join(f"{k} {v:.1f} GiB" for k, v in
                                      host_memory_gib().items()))
    f32 = torch.float32
    wd = torch.bfloat16 if args.mixed_precision == "bf16" else f32
    make_dit = {"14b": dit_14b, "1.3b": dit_1_3b,
                "tiny": dit_tiny}[args.model_size]
    cfg4 = make_dit(motion_guidance=True, in_dim=64 if args.use_depth else 48,
                    model_type="i2v", dtype=wd, param_dtype=wd)
    cfg_inp = make_dit(motion_guidance=False, in_dim=36, model_type="i2v",
                       dtype=wd, param_dtype=wd)
    if args.model_size == "tiny":
        # the real VAE's ratios and z_dim at tiny widths
        vae_cfg = VAEConfig(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2),
                            num_res_blocks=1,
                            temporal_downsample=(False, True, True),
                            dtype=wd, param_dtype=wd)
    else:
        vae_cfg = VAEConfig(dtype=wd, param_dtype=wd)

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        timings[name] = time.perf_counter() - t0
        print(f"load: {name} {timings[name]:.2f} s")
        return out

    def dit(path, cfg, lora, weight, name):
        """(module, host blocks or None). A LoRA merges in float32 before
        the one cast, as the JAX CLI merges, tensor by tensor; then the
        memory mode and the mesh (``place_dit``)."""
        sd = timed(name, load_wan_dit, path, cfg,
                   prefer_ema=args.use_ema_params,
                   dtype=f32 if lora else wd)
        if lora:
            factors = timed(name + "_lora", load_vism_lora, lora)
            timed(name + "_merge", merge_lora_, sd, factors, weight, wd)
        module = timed(name + "_module", from_state_dict,
                       lambda: WanDiT(cfg), sd, wd)
        del sd
        return place_dit(module, mesh, fp8=args.fp8_weights,
                         offload=args.offload_blocks, device=dev,
                         timed=lambda label, fn, *a, **k: timed(
                             f"{name}_{label}", fn, *a, **k))

    mesh = None
    if args.fsdp or args.sp > 1:
        # the JAX CLI's mesh: every rank on fsdp but the seq ranks
        from ..parallel import MeshConfig, create_mesh

        mesh = create_mesh(MeshConfig(data=1, fsdp=-1, seq=args.sp),
                           device=dev)

    print("loading checkpoints ...")
    dit4, host4 = (dit(args.control_ckpt, cfg4, args.stage1_lora,
                       args.stage1_lora_weight, "control_dit")
                   if args.run_stage1 else (None, None))
    dit_inp, host_inp = (dit(args.inp_ckpt, cfg_inp, args.vism_lora,
                             args.lora_weight, "inp_dit")
                         if args.run_stage2_complete else (None, None))
    vae_sd = timed("vae", load_wan_vae, args.vae_ckpt, vae_cfg, dtype=wd)
    dec_sd, vae_ft = timed("decoder_adaptor", load_adaptor,
                           args.decoder_adaptor, decoder=True)
    if vae_ft is not None:
        # the adaptor checkpoint carries a fine-tuned VAE decoder
        vae_sd.update({k: v for k, v in vae_ft.items()
                       if k.startswith(("decoder.", "conv2."))})
    vae = from_state_dict(lambda: WanVAE(vae_cfg), vae_sd, wd)
    dec = from_state_dict(lambda: VAEDecoderAdaptor(ch=args.adaptor_ch),
                          dec_sd, f32)

    tokenize = (build_tokenize(args.tokenizer, cfg4.text_len)
                if args.t5_ckpt else None)
    encoders = timed(
        "towers", build_encoders, t5=args.t5_ckpt, tokenize=tokenize,
        clip=args.clip_ckpt, omnimae=args.omnimae_ckpt,
        text_dim=cfg4.text_dim, text_len=cfg4.text_len,
        allow_dummy_text=args.allow_dummy_text,
        weight_dtype=None if wd == f32 else wd, device=dev)

    solver_kw = []
    if args.solver_order is not None:
        solver_kw.append(("solver_order", args.solver_order))
    if args.solver_type is not None:
        solver_kw.append(("solver_type", args.solver_type))
    if args.solver_algorithm is not None:
        solver_kw.append(("algorithm_type", args.solver_algorithm))
    if args.solver_thresholding:
        solver_kw.append(("thresholding", True))
    pcfg = PipelineConfig(
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, shift=args.shift,
        scheduler=args.sampler, scheduler_kwargs=tuple(solver_kw),
        num_frames=args.num_frames, height=args.height, width=args.width,
        teacache_threshold=args.teacache_threshold,
        cfg_skip_ratio=args.cfg_skip_ratio, riflex_k=args.riflex_k)
    pcfg2 = dataclasses.replace(
        pcfg,
        guidance_scale=(args.stage2_guidance_scale
                        if args.stage2_guidance_scale is not None
                        else args.guidance_scale),
        num_inference_steps=(args.stage2_num_inference_steps
                             if args.stage2_num_inference_steps is not None
                             else args.num_inference_steps))
    teacache = None
    if args.teacache_threshold > 0:
        key = ("wan2.1-fun-14b" if args.model_size == "14b"
               else "wan2.1-fun-1.3b")
        teacache = TeaCacheConfig(
            coefficients=tuple(TEACACHE_COEFFICIENTS[key]),
            rel_l1_thresh=args.teacache_threshold,
            num_skip_start_steps=args.num_skip_start_steps,
            offload_residual=args.teacache_offload)

    depth = None
    if args.run_stage1:
        if args.depth_provider == "precomputed":
            depth = get_depth_provider("precomputed",
                                       directory=args.depth_dir)
        elif args.depth_provider == "constant":
            depth = get_depth_provider("constant")
        else:
            if not args.depth_ckpt:
                # random-weight depth would poison the whole 4D output
                raise SystemExit(
                    "--depth_provider unidepth_jax needs --depth_ckpt "
                    "(UniDepth-V2 torch checkpoint). Alternatives: "
                    "--depth_provider precomputed --depth_dir DIR, or "
                    "--depth_provider constant for smoke tests.")
            depth = timed("unidepth", get_depth_provider, "unidepth_native",
                          ckpt=args.depth_ckpt, device=dev)
    models = timed("to_device", make_two_stage_models, dit4, dit_inp, vae,
                   dec, encoders, pcfg, pcfg2, device=dev,
                   estimate_depth=depth, teacache=teacache)
    for pipe, host in ((models.control_pipeline, host4),
                       (models.inpaint_pipeline, host_inp)):
        if host is not None:
            pipe.streamed_dit = StreamedDiT(pipe.dit, host, dev,
                                            rope_tables=pipe.rope_tables)
    if args.sp > 1:
        set_mesh(mesh)      # the DiTs' self-attention through Ulysses
    return models


def run_sample(models, image01, prompt: str, args,
               generator: torch.Generator, clouds=None) -> dict:
    """One sample: stage 1 on ``image01`` [H, W, 3] in [0, 1] (or, with
    ``clouds`` = (coords, colors) from an earlier run, none), the render of
    ``--trajectories``, and unless ``--no-run_stage2_complete`` stage 2
    (``infer/two_stage.py stage2_sweep`` with ``--stage2_batch``,
    ``--stage2_denoise_group`` and ``--[no-]stage2_shared_noise``).
    ``generator`` (on the models' device) gives the sweep's seed first,
    then stage 1's noise, so a resumed run inpaints with the noise of a
    whole one. ``--sweep_dp`` on more than one rank runs the sweep over a
    data mesh of the world; on one it warns and runs the serial sweep, as
    the JAX CLI does. Under ``--sp``
    or ``--sweep_dp`` every rank renders rank 0's clouds. Returns
    {'coords', 'colors', 'renders', 'videos' [{'name', 'video'}],
    'timings' {'stage1_s', 'render_s', 'stage2_s'}}, the device
    synchronised at each stage's end."""
    from ..infer.two_stage import (_StageClock, one_cloud,
                                   render_trajectories, stage1_generate,
                                   stage2_sweep)
    from ..parallel import MeshConfig, create_mesh
    from ..parallel.mesh import world_size

    dev = models.device
    timings: Dict[str, float] = {}
    seed2 = int(torch.randint(0, 2 ** 62, (), generator=generator,
                              device=generator.device))
    clock = _StageClock(dev, timings)
    if clouds is None:
        coords, colors = one_cloud(*stage1_generate(
            models, image01, prompt, args.negative_prompt,
            generator=generator, normalize_track_z=args.normalize_track_z,
            use_depth=args.use_depth), sweep=args.sweep_dp)
    else:
        coords, colors = (torch.as_tensor(c, device=dev) for c in clouds)
    clock.lap("stage1_s")
    renders = render_trajectories(coords, colors, args.height, args.width,
                                  pick_trajectories(args.trajectories),
                                  args.use_gs)
    clock.lap("render_s")
    videos = []
    if args.run_stage2_complete:
        neg2 = (args.stage2_negative_prompt
                if args.stage2_negative_prompt is not None
                else args.negative_prompt)
        sweep_dp = args.sweep_dp
        if sweep_dp and world_size() == 1 and len(renders) > 1:
            print("WARNING: --sweep_dp on a single device would run the "
                  f"whole {len(renders)}-trajectory sweep as one batch; "
                  "falling back to the serial sweep (use --stage2_batch "
                  "to batch explicitly)")
            sweep_dp = False
        # the sweep over the world's ranks, from the serial sweep's
        # first-chunk seed: the same videos
        sweep_mesh = create_mesh(MeshConfig(data=-1, fsdp=1, seq=1),
                                 device=dev) if sweep_dp else None
        videos = stage2_sweep(models, renders, prompt, neg2, seed2,
                              args.stage2_batch, args.stage2_denoise_group,
                              args.stage2_shared_noise, sweep_mesh)
    clock.lap("stage2_s")
    return {"coords": coords, "colors": colors, "renders": renders,
            "videos": videos, "timings": timings}


def _read_image(path: str) -> np.ndarray:
    if path.lower().endswith(VIDEO_EXTS):
        # a video conditions on its first frame, as the reference's
        # dataset loop does
        from ..utils.artifacts import read_video_frames

        return read_video_frames(path, 1)[0]
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def process_sample(models, image_path: str, prompt: str, args,
                   generator: torch.Generator) -> None:
    """``run_sample`` with the JAX CLI's files: stage 1 writes
    ``{name}_coords.npy``, ``_colors.npy`` and the frame-0 cloud
    ``_frame0.txt``, or ``--no-run_stage1`` reads the first two back; the
    renders and hole masks are written with ``--save_renders`` or when
    stage 2 does not run; each inpainted video as ``{name}_{traj}.mp4``.
    On a mesh rank 0 alone writes."""
    from ..parallel.mesh import is_main_process
    from ..utils.artifacts import save_pointcloud_txt, save_videos_grid

    name = os.path.splitext(os.path.basename(image_path))[0]
    out_dir = args.output_dir
    coords_path = os.path.join(out_dir, f"{name}_coords.npy")
    colors_path = os.path.join(out_dir, f"{name}_colors.npy")
    if args.run_stage1:
        image01, clouds = _read_image(image_path), None
        if hasattr(models.estimate_depth, "set_current"):
            models.estimate_depth.set_current(name)
    else:
        if not (os.path.exists(coords_path) and os.path.exists(colors_path)):
            raise SystemExit(f"--no-run_stage1 needs {coords_path} and "
                             f"{colors_path} from a prior stage-1 run")
        image01, clouds = None, (np.load(coords_path), np.load(colors_path))
    out = run_sample(models, image01, prompt, args, generator, clouds)
    if not is_main_process():
        return                  # every rank holds the outputs; one writes
    if args.run_stage1:
        coords = out["coords"].float().cpu().numpy()
        colors = out["colors"].float().cpu().numpy()
        np.save(coords_path, coords)
        np.save(colors_path, colors)
        save_pointcloud_txt(os.path.join(out_dir, f"{name}_frame0.txt"),
                            coords[0], colors)
    if args.save_renders or not args.run_stage2_complete:
        for r in out["renders"]:
            rp = os.path.join(out_dir, f"{name}_{r['name']}_render.mp4")
            save_videos_grid(rp, r["frames"][None], fps=args.fps)
            mask = r["mask"].float()[..., None].expand(*r["mask"].shape, 3)
            save_videos_grid(os.path.join(out_dir,
                                          f"{name}_{r['name']}_mask.mp4"),
                             mask[None], fps=args.fps)
            print("wrote", rp)
    for v in out["videos"]:
        path = os.path.join(out_dir, f"{name}_{v['name']}.mp4")
        save_videos_grid(path, v["video"][None], fps=args.fps)
        print("wrote", path)


def _plan(args) -> List[tuple]:
    """(path, prompt) per sample: --image, or every image and video of
    --image_dir, prompts resolved up front so a missing one stops the run
    before any work."""
    if args.image:
        return [(args.image, args.prompt)]
    paths = sorted(os.path.join(args.image_dir, f)
                   for f in os.listdir(args.image_dir)
                   if f.lower().endswith(IMAGE_EXTS + VIDEO_EXTS))
    if args.max_samples:
        paths = paths[:args.max_samples]
    if not paths:
        raise SystemExit(f"no images in {args.image_dir}")
    prompts = {}
    if args.prompts_json:
        with open(args.prompts_json) as f:
            prompts = json.load(f)
    plan = []
    for pth in paths:
        key = os.path.splitext(os.path.basename(pth))[0]
        prompt = prompts.get(key, args.prompt)
        if prompt is None:
            raise SystemExit(f"no prompt for {key!r}: add it to "
                             f"--prompts_json or set --prompt as the shared "
                             f"fallback")
        plan.append((pth, prompt))
    return plan


def main(argv=None, device="cuda") -> int:
    """The CLI on ``device`` (the card by default; the tests pass
    ``"cpu"``). Under ``torchrun`` every rank runs it: ``--fsdp`` and
    ``--sp`` shard the DiTs and split their sequence over the ranks,
    ``--sweep_dp`` the trajectories."""
    from ..parallel.mesh import init_distributed, world_size

    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    if args.only_render:
        args.run_stage1 = False
    if bool(args.image) == bool(args.image_dir):
        raise SystemExit("give exactly one of --image or --image_dir")
    if args.image and not args.prompt:
        raise SystemExit("--prompt is required with --image")
    pick_trajectories(args.trajectories)
    plan = _plan(args)
    os.makedirs(args.output_dir, exist_ok=True)
    if world_size() > 1:
        init_distributed(dev)   # each rank on its card before any load
    models = load_models(args, dev)
    for i, (path, prompt) in enumerate(plan):
        if len(plan) > 1:
            print(f"[{i + 1}/{len(plan)}] {path}")
        generator = torch.Generator(dev).manual_seed(args.seed + i)
        ctx = contextlib.nullcontext()
        if args.profile_dir:
            from ..utils.profiling import trace

            ctx = trace(args.profile_dir)
        with ctx:
            process_sample(models, path, prompt, args, generator)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
