"""4D-STraG training CLI (PyTorch port of ``scripts/train_straag.py``, with
its flags and defaults).

    python -m more4d_tpu_torch.scripts.train_straag --data_dir data/ \\
      --pretrained_ckpt /ckpts/Wan2.1-Fun-V1.1-1.3B-Control \\
      --vae_ckpt /ckpts/Wan2.1_VAE.pth \\
      --encoder_adaptor /ckpts/encoder_adaptor.bin \\
      --t5_ckpt /ckpts/models_t5_umt5-xxl-enc-bf16.pth \\
      --clip_ckpt /ckpts/models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth \\
      --omnimae_ckpt /ckpts/omnimae_vitb.pth \\
      --model_size 1.3b --output_dir straag_ckpt/

Per step: a scene-flow pickle (``*_dt3d_pred.pkl``) -> depth-guided
normalisation -> the encoder adaptor -> the frozen VAE's latents and the
48-channel conditioning (2% control dropout) -> umT5 text with 10%
dropout, CLIP first-frame features with 2% dropout, OmniMAE MPM tokens ->
the flow-matching step (stratified timesteps, the loss guards, the
dynamic clamp, gradient accumulation, EMA) -> checkpoints carrying the
data order, JSONL metrics, validation videos through the control
pipeline. ``--remat_policy`` picks what each block keeps for the backward
(``nn/remat.py``).

One card: the 1.3B trains in full on an 80 GB card (fp32 weights,
gradients, AdamW moments and EMA, ~23 GB, with the towers beside them).
A full fine-tune of the 14B, the default ``--model_size`` as in the JAX
CLI, holds ~280 GB of that state and needs the FSDP mesh (``--mesh``),
which the port does not have yet.

``main(argv, device)`` is the program; ``run_training`` its loop, for
callers that bring their own models and batches; ``make_batch_iterator``
the data. The same ``--seed`` gives the JAX CLI's data order and dropouts
(numpy ``RandomState``), and other timestep and noise draws (a
``torch.Generator`` where it splits ``PRNGKey(seed)``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..nn.remat import REMAT_POLICIES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m more4d_tpu_torch.scripts.train_straag",
        description="4D-STraG training")
    p.add_argument("--data_dir", required=True,
                   help="directory of *_dt3d_pred.pkl sceneflow files")
    p.add_argument("--prompts_json", default=None,
                   help="json mapping pkl basename -> text prompt")
    p.add_argument("--pretrained_ckpt", required=True)
    p.add_argument("--vae_ckpt", required=True)
    p.add_argument("--t5_ckpt", default=None)
    p.add_argument("--tokenizer", default="google/umt5-xxl")
    p.add_argument("--clip_ckpt", default=None)
    p.add_argument("--omnimae_ckpt", default=None)
    p.add_argument("--encoder_adaptor", required=True)
    p.add_argument("--output_dir", default="straag_ckpt")
    p.add_argument("--batch_size", type=int, default=1,
                   help="per-step batch")
    p.add_argument("--mesh", default=None,
                   help="device-mesh topology, e.g. 'data=2,fsdp=4' (-1 "
                        "absorbs the remaining devices). The port runs on "
                        "one device: only a spec of one device is taken")
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="micro-batch gradient accumulation: apply the "
                        "mean gradient every k-th step (reference "
                        "--gradient_accumulation_steps)")
    p.add_argument("--use_ema", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="keep an EMA of the weights (reference --use_ema; "
                        "--no-use_ema saves the memory)")
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    # the reference's shipped launch values, not its argparse defaults
    p.add_argument("--lr_scheduler", default="constant_with_warmup",
                   choices=["constant", "constant_with_warmup", "linear",
                            "cosine"])
    p.add_argument("--lr_warmup_steps", type=int, default=100)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=3e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-10)
    p.add_argument("--checkpoints_total_limit", type=int, default=2,
                   help="checkpoints kept (reference "
                        "--checkpoints_total_limit)")
    p.add_argument("--uniform_sampling",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="rank-stratified uniform timestep sampling; "
                        "--no-uniform_sampling uses the SD3 density "
                        "sampler under --weighting_scheme")
    p.add_argument("--weighting_scheme", default="none",
                   choices=["sigma_sqrt", "logit_normal", "mode",
                            "cosmap", "none"],
                   help="SD3 sampling-density / loss-weighting scheme")
    p.add_argument("--logit_mean", type=float, default=0.0)
    p.add_argument("--logit_std", type=float, default=1.0)
    p.add_argument("--mode_scale", type=float, default=1.29)
    p.add_argument("--train_sampling_steps", type=int, default=1000,
                   help="timestep-grid size for the stratified sampler "
                        "(reference --train_sampling_steps)")
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "came"],
                   help="came = the reference's --use_came path")
    p.add_argument("--trainable_modules", default=None,
                   help="comma-separated name substrings, matched in each "
                        "parameter's JAX path (params/blocks/block/ffn/fc1/"
                        "kernel); params matching none are frozen (the "
                        "reference's --trainable_modules). Default: full "
                        "fine-tune")
    p.add_argument("--low_lr_names", default=None,
                   help="regex over the JAX parameter paths trained at "
                        "learning_rate*low_lr_ratio (two-tier LR groups)")
    p.add_argument("--low_lr_ratio", type=float, default=0.1)
    p.add_argument("--allow_dummy_text", action="store_true",
                   help="permit training without --t5_ckpt (zero text "
                        "embeddings; smoke runs only)")
    p.add_argument("--frozen_dtype", default="bf16",
                   choices=["bf16", "fp32"],
                   help="storage dtype for the FROZEN towers "
                        "(VAE/T5/CLIP/OmniMAE); the trained DiT keeps fp32 "
                        "weights with bf16 compute either way")
    p.add_argument("--report_model_info", action="store_true",
                   help="log per-parameter grad norms (grad_norm/<name> in "
                        "metrics.jsonl)")
    p.add_argument("--remat_policy", default="nothing",
                   choices=list(REMAT_POLICIES),
                   help="what each rematerialised block keeps for the "
                        "backward: nothing; dots (matmul outputs); "
                        "flash_lite (K1's o and lse), flash (+ post-RoPE "
                        "q, k, v), flash_ffn (+ fc1's output); '_offload' "
                        "parks them in pinned host memory")
    p.add_argument("--split_step", action="store_true",
                   help="the JAX CLI's two-jit step; the port's eager step "
                        "decides the abnormal-loss skip on the host "
                        "anyway, so this changes nothing")
    p.add_argument("--max_grad_norm", type=float, default=0.05)
    p.add_argument("--max_steps", type=int, default=10000)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--validation_steps", type=int, default=0)
    p.add_argument("--height", type=int, default=368)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--buckets", default=None,
                   help="comma-separated HxW aspect buckets, e.g. "
                        "'368x512,416x416,512x368' (default: single "
                        "canonical shape)")
    p.add_argument("--num_frames", type=int, default=49)
    p.add_argument("--motion_sub_loss", action="store_true")
    p.add_argument("--control_dropout", type=float, default=0.02)
    p.add_argument("--text_dropout", type=float, default=0.1)
    p.add_argument("--skip_large_depth",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="drop samples whose depth range exceeds the "
                        "threshold (reference --skip_large_depth)")
    p.add_argument("--max_samples", type=int, default=None,
                   help="cap the dataset to its first N pkls")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--model_size", default="14b", choices=["14b", "1.3b"])
    p.add_argument("--resume", action="store_true")
    return p


def check_mesh(spec: Optional[str]) -> None:
    """Take no spec, or one of a single device ('fsdp=1', 'data=1,fsdp=-1',
    ...: -1 absorbs the one device); raise for a larger mesh."""
    if not spec:
        return
    sizes = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in ("data", "fsdp", "seq", "dcn"):
            raise ValueError(f"unknown mesh axis {k!r} (expected "
                             f"dcn/data/fsdp/seq)")
        sizes[k] = int(v)
    if any(n not in (1, -1) for n in sizes.values()):
        raise NotImplementedError(
            f"--mesh {spec}: the port trains on one device; FSDP and data "
            f"parallelism are ROADMAP Queue 1, item 5 (parallel/mesh.py)")


def resize_bilinear(x: np.ndarray, height: int, width: int) -> np.ndarray:
    """[..., H, W, C] float32 -> [..., height, width, C], bilinear on
    half-pixel centres without antialiasing (``cv2.resize`` with
    INTER_LINEAR, which the JAX CLI calls)."""
    lead = x.shape[:-3]
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).reshape(
        -1, *x.shape[-3:]).permute(0, 3, 1, 2)
    out = F.interpolate(t, size=(height, width), mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1).reshape(*lead, height, width,
                                           x.shape[-1]).numpy()


def make_batch_iterator(files, prompts, sampler, batch_size, height, width,
                        num_frames, buckets=None, skip_large_depth=True):
    """(samples, prompts) batches of ``batch_size`` from the pickles that
    ``sampler`` (an iterator of indices into ``files``) picks.

    By default every sample keeps one canonical shape (height, width). With
    ``buckets`` (a list of (H, W)) a sample is resized to the bucket
    closest to its aspect ratio, and batches gather per bucket. A pickle
    that fails to load or prepare is skipped."""
    from ..data.sceneflow import load_sceneflow_pickle, prepare_straag_sample

    pools = {}

    def bucket_for(h, w):
        if not buckets:
            return (height, width)
        ratio = h / w
        return min(buckets, key=lambda bw: abs(bw[0] / bw[1] - ratio))

    def gen():
        for idx in sampler:
            path = files[idx]
            try:
                coords, colors = load_sceneflow_pickle(path, height, width)
                bh, bw = bucket_for(*coords.shape[1:3])
                if coords.shape[1:3] != (bh, bw):
                    coords = resize_bilinear(coords, bh, bw)
                    colors = resize_bilinear(colors, bh, bw)
                sample = prepare_straag_sample(
                    coords, colors, max_num_frames=num_frames,
                    skip_large_depth=skip_large_depth)
            except (OSError, EOFError, KeyError, ValueError,
                    pickle.UnpicklingError) as e:   # a bad pickle: go on
                print(f"skipping {path}: {e}")
                continue
            if sample is None:
                continue
            name = os.path.splitext(os.path.basename(path))[0]
            pool = pools.setdefault((bh, bw), ([], []))
            pool[0].append(sample)
            pool[1].append(prompts.get(name, ""))
            if len(pool[0]) == batch_size:
                yield pool[0][:], pool[1][:]
                pool[0].clear()
                pool[1].clear()

    return gen()


def trainable_filter(dit, modules: Optional[str]):
    """--trainable_modules as a filter over the port's parameter names,
    deciding each on its JAX path (``utils/quantize.jax_param``); None for
    a full fine-tune."""
    if not modules:
        return None
    from ..utils.quantize import jax_param

    names = [n.strip() for n in modules.split(",") if n.strip()]
    paths = {n: jax_param(n, p)[0] for n, p in dit.named_parameters()}
    return lambda name: any(s in paths[name] for s in names)


def build_optimizer(dit, args):
    """(optimizer, LambdaLR or None) over ``dit``'s trainable parameters:
    AdamW at the CLI's betas, weight decay and eps, or CAME at its own
    (the JAX CLI's ``came(lr)``); with ``--low_lr_names`` two groups. The
    schedule counts optimizer steps (``max_steps // grad_accum_steps``)."""
    from ..train.optim import make_lr_schedule, make_optimizer

    lr = make_lr_schedule(
        args.learning_rate, args.lr_scheduler, args.lr_warmup_steps,
        max(args.max_steps // max(args.grad_accum_steps, 1), 1))
    named = [(n, p) for n, p in dit.named_parameters() if p.requires_grad]
    if args.optimizer == "came":
        return make_optimizer("came", named, lr, weight_decay=1e-2,
                              low_lr_names=args.low_lr_names,
                              low_lr_ratio=args.low_lr_ratio)
    return make_optimizer("adamw", named, lr,
                          betas=(args.adam_beta1, args.adam_beta2),
                          weight_decay=args.adam_weight_decay,
                          eps=args.adam_epsilon,
                          low_lr_names=args.low_lr_names,
                          low_lr_ratio=args.low_lr_ratio)


def run_training(dit, vae, enc, encoders, batches, args, device="cuda",
                 timings: Optional[list] = None, sampler=None):
    """The loop, callable with tiny or pre-built models. ``encoders``: a
    ``ConditioningEncoders``; ``batches`` yields (samples, prompts);
    ``sampler`` (a ``ResumableSampler``), when given, goes into the
    checkpoints (``main`` restores it before ``batches`` starts drawing).
    ``timings``, when given, gets one dict a step
    (``StraagTrainer.train``). Returns the trainer."""
    from ..config import PipelineConfig
    from ..pipelines import WanControlPipeline
    from ..train.harness import StraagRunConfig, StraagTrainer
    from ..train.train_straag import StraagTrainConfig

    check_mesh(args.mesh)
    dev = resolve_device(device)
    dit = dit.to(dev)
    keep = trainable_filter(dit, args.trainable_modules)
    if keep is not None:
        for name, p in dit.named_parameters():
            p.requires_grad_(keep(name))
    optimizer, scheduler = build_optimizer(dit, args)
    tcfg = StraagTrainConfig(
        learning_rate=args.learning_rate, max_grad_norm=args.max_grad_norm,
        motion_sub_loss=args.motion_sub_loss,
        grad_accum_steps=args.grad_accum_steps, use_ema=args.use_ema,
        ema_decay=args.ema_decay,
        num_train_timesteps=args.train_sampling_steps,
        uniform_sampling=args.uniform_sampling,
        weighting_scheme=args.weighting_scheme, logit_mean=args.logit_mean,
        logit_std=args.logit_std, mode_scale=args.mode_scale)
    rcfg = StraagRunConfig(
        output_dir=args.output_dir, batch_size=args.batch_size,
        max_steps=args.max_steps,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        validation_steps=args.validation_steps,
        control_dropout=args.control_dropout,
        text_dropout=args.text_dropout, seed=args.seed, resume=args.resume)
    validation_pipeline = None
    if args.validation_steps:
        validation_pipeline = WanControlPipeline(
            dit, vae, PipelineConfig(num_frames=args.num_frames,
                                     height=args.height, width=args.width,
                                     num_inference_steps=20), device=dev)
    trainer = StraagTrainer(
        dit, vae.to(dev), enc.to(dev), encoders.encode_text, tcfg, rcfg,
        encode_clip=encoders.encode_clip, extract_mpm=encoders.extract_mpm,
        optimizer=optimizer, lr_scheduler=scheduler,
        validation_pipeline=validation_pipeline, trainable_filter=keep,
        report_grad_norms=args.report_model_info,
        split_step=args.split_step)
    trainer.train(batches, timings=timings,
                  extra_state=None if sampler is None else sampler.state_dict)
    return trainer


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    check_mesh(args.mesh)
    dev = resolve_device(device)
    from ..config import VAEConfig, dit_1_3b, dit_14b
    from ..convert.dit_torch import load_wan_dit
    from ..convert.vae_torch import load_wan_vae
    from ..data import ResumableSampler
    from ..data.prefetch import prefetch
    from ..infer.encoders import build_encoders, build_tokenize
    from ..models import VAEEncoderAdaptor, WanDiT, WanVAE
    from ..models.adaptors import load_adaptor
    from ..nn.layers import from_state_dict
    from ..train.checkpoint import CheckpointManager

    make_dit = dit_14b if args.model_size == "14b" else dit_1_3b
    cfg = make_dit(motion_guidance=True, in_dim=64, model_type="i2v",
                   remat=True, remat_policy=args.remat_policy)
    fdt = torch.bfloat16 if args.frozen_dtype == "bf16" else torch.float32
    dit = from_state_dict(lambda: WanDiT(cfg),
                          load_wan_dit(args.pretrained_ckpt, cfg),
                          torch.float32)
    vae_cfg = VAEConfig(dtype=fdt, param_dtype=fdt)
    vae = from_state_dict(lambda: WanVAE(vae_cfg),
                          load_wan_vae(args.vae_ckpt, vae_cfg), fdt)
    enc_sd, _ = load_adaptor(args.encoder_adaptor, decoder=False)
    enc = from_state_dict(VAEEncoderAdaptor, enc_sd, torch.float32)
    encoders = build_encoders(
        t5=args.t5_ckpt,
        tokenize=(build_tokenize(args.tokenizer, cfg.text_len)
                  if args.t5_ckpt else None),
        clip=args.clip_ckpt, omnimae=args.omnimae_ckpt,
        text_dim=cfg.text_dim, text_len=cfg.text_len,
        allow_dummy_text=args.allow_dummy_text, weight_dtype=fdt,
        device=dev)

    files = sorted(glob.glob(os.path.join(args.data_dir,
                                          "*_dt3d_pred.pkl")))
    if not files:
        raise SystemExit(f"no *_dt3d_pred.pkl files in {args.data_dir}")
    if args.max_samples:
        files = files[:args.max_samples]
    prompts = {}
    if args.prompts_json:
        with open(args.prompts_json) as f:
            prompts = json.load(f)
    buckets = None
    if args.buckets:
        buckets = [tuple(int(v) for v in b.split("x"))
                   for b in args.buckets.split(",")]
    sampler = ResumableSampler(len(files), seed=args.seed)
    if args.resume:
        # the data order resumes before the prefetch workers first draw
        extra = CheckpointManager(args.output_dir).restore_extra() or {}
        if "data" in extra:
            sampler.load_state_dict(extra["data"])
    batches = make_batch_iterator(files, prompts, iter(sampler),
                                  args.batch_size, args.height, args.width,
                                  args.num_frames, buckets=buckets,
                                  skip_large_depth=args.skip_large_depth)
    ahead = prefetch(batches, depth=2, num_workers=2)
    try:
        run_training(dit, vae, enc, encoders, ahead, args, device=dev,
                     sampler=sampler)
    finally:
        ahead.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
