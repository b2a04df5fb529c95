"""4D-ViSM LoRA training CLI (PyTorch port of ``scripts/train_vism.py``,
with its flags and defaults).

    python -m more4d_tpu_torch.scripts.train_vism --data_dir data/ \\
      --pretrained_ckpt /ckpts/Wan2.1-Fun-V1.1-1.3B-InP \\
      --vae_ckpt /ckpts/Wan2.1_VAE.pth \\
      --t5_ckpt /ckpts/models_t5_umt5-xxl-enc-bf16.pth \\
      --clip_ckpt /ckpts/models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth \\
      --model_size 1.3b --output_dir vism_lora/ --export_kohya

At 14B (the default ``--model_size``) one card holds the base only with
``--offload_blocks``: its block weights stream fp8 from pinned host memory
for the forward and again for the backward's recompute
(``train/lora_streamed.py``); the LoRA factors and their optimizer state
stay on the card.

Per step: a ViSM training pair (the projected or pre-rendered novel view
and its holes, ``data/vism.py``) -> the frozen VAE's latents of the
original and the masked video -> the folded 4-channel mask latents -> the
inpaint conditioning zeroed by the t2v flag -> the LoRA-only flow-matching
step -> LoRA-only checkpoints (``train/checkpoint.py``) and metrics.

``main(argv, device)`` is the program; ``run_training`` its loop, for
callers that bring their own models and samples. The same ``--seed``
gives other factors and noise than the JAX CLI (a ``torch.Generator``
where it splits ``PRNGKey(seed)``); the data's dropouts come from the same
numpy ``RandomState``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..nn.remat import REMAT_POLICIES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m more4d_tpu_torch.scripts.train_vism",
        description="4D-ViSM LoRA training")
    p.add_argument("--data_dir", required=True,
                   help="dir with videos/*.mp4 and their dt3d_render/ "
                        "pairs (the reference's path conventions)")
    p.add_argument("--prompts_json", default=None)
    p.add_argument("--pretrained_ckpt", required=True,
                   help="Wan-Fun-InP base checkpoint")
    p.add_argument("--vae_ckpt", required=True)
    p.add_argument("--t5_ckpt", default=None)
    p.add_argument("--allow_dummy_text", action="store_true",
                   help="permit training without --t5_ckpt (zero text "
                        "embeddings; smoke runs only)")
    p.add_argument("--frozen_dtype", default="bf16",
                   choices=["bf16", "fp32"],
                   help="storage dtype of the FROZEN towers (VAE/T5/CLIP)")
    p.add_argument("--tokenizer", default="google/umt5-xxl")
    p.add_argument("--clip_ckpt", default=None)
    p.add_argument("--use_3dgs", action="store_true",
                   help="use the pre-rendered *_dt3d_render.mp4 instead of "
                        "the live point projection")
    p.add_argument("--output_dir", default="vism_lora_ckpt")
    p.add_argument("--lora_rank", type=int, default=4)
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="micro-batch gradient accumulation (reference "
                        "--gradient_accumulation_steps)")
    p.add_argument("--lora_alpha", type=float, default=4.0)
    p.add_argument("--lora_skip_name", default=None,
                   help="skip LoRA on weights whose name contains this "
                        "substring (reference --lora_skip_name)")
    p.add_argument("--export_kohya", action="store_true",
                   help="also write lora_kohya.safetensors at each "
                        "checkpoint, the reference's merge_lora format")
    p.add_argument("--train_text_encoder", action="store_true",
                   help="also LoRA-train the umT5 text encoder; requires "
                        "--t5_ckpt")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--max_grad_norm", type=float, default=1.0,
                   help="LoRA-gradient global-norm clip")
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "came"],
                   help="came = the reference's --use_came")
    p.add_argument("--motion_sub_loss", action="store_true",
                   help="temporal-difference loss term")
    p.add_argument("--motion_sub_loss_ratio", type=float, default=0.25)
    p.add_argument("--uniform_sampling",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="--no-uniform_sampling switches to the SD3 density "
                        "sampler under --weighting_scheme")
    p.add_argument("--weighting_scheme", default="none",
                   choices=["sigma_sqrt", "logit_normal", "mode", "cosmap",
                            "none"])
    p.add_argument("--logit_mean", type=float, default=0.0)
    p.add_argument("--logit_std", type=float, default=1.0)
    p.add_argument("--mode_scale", type=float, default=1.29)
    p.add_argument("--lr_scheduler", default="constant",
                   choices=["constant", "constant_with_warmup", "linear",
                            "cosine"])
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--adam_weight_decay", type=float, default=3e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-10)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--remat_policy", default="nothing",
                   choices=list(REMAT_POLICIES),
                   help="what each rematerialised block keeps for the "
                        "backward (nn/remat.py)")
    p.add_argument("--max_steps", type=int, default=10000)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--log_steps", type=int, default=20)
    p.add_argument("--height", type=int, default=368)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num_frames", type=int, default=49)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--model_size", default="14b", choices=["14b", "1.3b"])
    p.add_argument("--offload_blocks", action="store_true",
                   help="stream the frozen base's block weights fp8 from "
                        "pinned host memory for the forward AND the "
                        "backward (train/lora_streamed.py); the LoRA "
                        "factors stay on the card")
    p.add_argument("--resume", action="store_true")
    return p


@torch.no_grad()
def prepare_vism_batch(sample, vae, encode_text, encode_clip,
                       encode_fn=None, tokenize=None) -> dict:
    """ViSMSample -> the step's batch. With ``tokenize``
    (--train_text_encoder) the batch carries input_ids and attention_mask
    and the step encodes the text inside its loss."""
    from ..models.vae_streaming import encode_streamed
    from ..pipelines.inpaint import (fold_mask_to_latent_channels,
                                     resize_mask_to_latent)

    dev = next(vae.parameters()).device
    enc = encode_fn or (lambda v: encode_streamed(vae, v)[0])
    latents = enc(sample.pixel_values[None].to(dev)).float()
    mask_latents = enc(sample.mask_pixel_values[None].to(dev)).float()
    mask1 = sample.mask[..., :1][None].to(dev)          # [1,T,H,W,1]
    mask4 = resize_mask_to_latent(fold_mask_to_latent_channels(1.0 - mask1),
                                  latents.shape)
    y = torch.cat([mask4.float(), mask_latents], dim=-1)
    y = y * sample.t2v_keep_flag                          # the t2v flag
    batch = {"latents": latents, "y": y}
    if tokenize is not None:
        ids, mask = tokenize([sample.text])
        batch["input_ids"] = torch.as_tensor(ids).to(dev)
        batch["attention_mask"] = torch.as_tensor(mask).to(dev)
    else:
        batch["context"] = encode_text([sample.text]).float().to(dev)
    if encode_clip is not None:
        batch["clip_fea"] = encode_clip(
            sample.clip_image01[None].to(dev) * 2.0 - 1.0)
    return batch


def load_vism_video(path, num_frames, size):
    """An original clip's frames sampled as its renders are (stride 2
    beyond the budget, last-frame padding), so original frame i pairs with
    render frame i."""
    from ..data.vism import pad_frames, sample_frame_indices
    from ..utils.artifacts import read_video_frames

    video = read_video_frames(path, size=size)
    return pad_frames(video[sample_frame_indices(video.shape[0],
                                                 num_frames)], num_frames)


def _detached(lora):
    if "factors" not in lora:
        return {k: _detached(v) for k, v in lora.items()}
    return {"rank": lora["rank"], "alpha": lora["alpha"],
            "factors": {n: {k: t.detach().cpu() for k, t in f.items()}
                        for n, f in lora["factors"].items()}}


def _load_factors_(lora, saved):
    if "factors" not in lora:
        for k in lora:
            _load_factors_(lora[k], saved[k])
        return
    with torch.no_grad():
        for n, f in lora["factors"].items():
            for k, t in f.items():
                t.copy_(saved["factors"][n][k])


def _optimizer(args, leaves, accum):
    from ..train.optim import make_lr_schedule, make_optimizer

    # total steps in optimizer steps: the schedule advances once per
    # accumulated update, not per micro-step
    schedule = make_lr_schedule(
        args.learning_rate, args.lr_scheduler, args.lr_warmup_steps,
        max(args.max_steps // accum, 1))
    return make_optimizer(
        args.optimizer, leaves, schedule,
        betas=(args.adam_beta1, args.adam_beta2),
        weight_decay=args.adam_weight_decay,
        eps=args.adam_epsilon)


def run_training(dit, vae, encode_text, sample_iter, args, encode_clip=None,
                 text_encoder=None, tokenize=None, device="cuda",
                 timings: Optional[list] = None):
    """The loop, callable with tiny models. Returns the trained LoRA.

    ``dit``: the InP ``WanDiT`` with its base weights, or a one-element
    list holding it, which is emptied so that with --offload_blocks the
    host copy of the base is freed once its blocks are pinned (at 14B a
    second host copy is ~57 GB in fp32); or a ``StreamedDiT`` whose
    blocks are already in host memory. ``text_encoder``: the umT5 module,
    with ``tokenize``, for --train_text_encoder. ``timings``, when given,
    gets one dict a step with the seconds of the batch preparation and of
    the step (the device synchronised)."""
    from ..parallel.offload import StreamedDiT
    from ..train.checkpoint import CheckpointManager
    from ..train.lora import TE_LORA_TARGETS, create_lora
    from ..train.train_straag import draw
    from ..train.optim import GradUpdate
    from ..train.train_vism import (VismTrainConfig, factor_leaves,
                                    train_step)
    from ..utils.metrics import MetricsLogger

    if isinstance(dit, list):
        dit = dit.pop()
    dev = resolve_device(device)
    tcfg = VismTrainConfig(
        learning_rate=args.learning_rate,
        max_grad_norm=args.max_grad_norm,
        motion_sub_loss=args.motion_sub_loss,
        motion_sub_loss_ratio=args.motion_sub_loss_ratio,
        uniform_sampling=args.uniform_sampling,
        weighting_scheme=args.weighting_scheme,
        logit_mean=args.logit_mean,
        logit_std=args.logit_std,
        mode_scale=args.mode_scale)
    accum = max(args.grad_accum_steps, 1)
    train_te = (text_encoder is not None
                and args.train_text_encoder)
    skip_name = args.lora_skip_name
    gen = torch.Generator(dev).manual_seed(args.seed)
    offload = args.offload_blocks or isinstance(dit, StreamedDiT)
    if offload:
        if train_te:
            raise SystemExit("--train_text_encoder is incompatible with "
                             "--offload_blocks (the streamed trainer "
                             "recomputes only the DiT)")
        from ..train.lora_streamed import make_streamed_lora_trainer

        trainer, lora = make_streamed_lora_trainer(
            dit, tcfg, gen, rank=args.lora_rank, alpha=args.lora_alpha,
            quantize="fp8", skip_name=skip_name, device=dev)
        del dit     # the blocks now live in host memory

        def step(batch, idx, noise):
            return trainer.train_step(lora, update, batch, idx, noise)
    else:
        dit = dit.to(dev).requires_grad_(False)
        if train_te:
            text_encoder = text_encoder.to(dev).requires_grad_(False)
            lora = {"dit": create_lora(dit.state_dict(), gen,
                                       rank=args.lora_rank,
                                       alpha=args.lora_alpha,
                                       skip_name=skip_name),
                    "te": create_lora(
                        text_encoder.state_dict(),
                        torch.Generator(dev).manual_seed(args.seed + 1),
                        rank=args.lora_rank, alpha=args.lora_alpha,
                        targets=TE_LORA_TARGETS, skip_name=skip_name)}
        else:
            lora = create_lora(dit.state_dict(), gen, rank=args.lora_rank,
                               alpha=args.lora_alpha, skip_name=skip_name)

        def step(batch, idx, noise):
            return train_step(dit, update, tcfg, lora, batch, idx, noise,
                              text_encoder if train_te else None)
    leaves = factor_leaves(lora)
    optimizer, scheduler = _optimizer(args, leaves, accum)
    update = GradUpdate(leaves, optimizer, scheduler, tcfg.max_grad_norm,
                        accum)

    os.makedirs(args.output_dir, exist_ok=True)
    metrics = MetricsLogger(args.output_dir)
    mgr = CheckpointManager(args.output_dir)
    generator = torch.Generator(dev).manual_seed(args.seed)
    global_step = 0
    if args.resume and mgr.latest_step() is not None:
        out = mgr.restore(with_extra=True, map_location=dev)
        _load_factors_(lora, out["params"])
        update.load_state_dict(out["opt_state"])
        generator.set_state(out["rng"].cpu())
        global_step = (out.get("extra") or {}).get("global_step", 0)

    def sync():
        if timings is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    for sample in sample_iter:
        if global_step >= args.max_steps:
            break
        t0 = sync()
        batch = prepare_vism_batch(sample, vae, encode_text, encode_clip,
                                   tokenize=tokenize if train_te else None)
        t1 = sync()
        idx, noise = draw(tcfg, batch, generator)
        m = step(batch, idx, noise)
        t2 = sync()
        if timings is not None:
            timings.append({"prepare_s": t1 - t0, "step_s": t2 - t1})
        global_step += 1
        if global_step % args.log_steps == 0 or global_step == 1:
            metrics.log(global_step, m, prefix="train")
            print(f"step {global_step}: loss={m['loss']:.4f}")
        if global_step % args.checkpointing_steps == 0:
            # a LoRA-only checkpoint, as the reference saves only the network
            mgr.save(global_step, _detached(lora),
                     opt_state=update.state_dict(),
                     rng=generator.get_state(),
                     extra={"global_step": global_step})
            if args.export_kohya:
                from ..convert.lora_torch import save_kohya_lora

                if train_te:
                    print("NOTE: --export_kohya writes the DiT factors; the "
                          "text-encoder factors stay in the checkpoint")
                save_kohya_lora(os.path.join(args.output_dir,
                                             "lora_kohya.safetensors"),
                                _detached(lora["dit"] if train_te else lora))
    metrics.close()
    mgr.close()
    return lora


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    from ..config import T5Config, VAEConfig, dit_1_3b, dit_14b
    from ..convert.dit_torch import load_wan_dit
    from ..convert.vae_torch import load_wan_vae
    from ..data.prefetch import prefetch
    from ..data.vism import load_prerendered, prepare_vism_sample
    from ..infer.encoders import _tower, build_encoders, build_tokenize
    from ..models import WanDiT, WanVAE
    from ..models.t5 import WanT5Encoder
    from ..nn.layers import from_state_dict

    make_dit = dit_14b if args.model_size == "14b" else dit_1_3b
    cfg = make_dit(motion_guidance=False, in_dim=36, model_type="i2v",
                   remat=True, remat_policy=args.remat_policy)
    fdt = torch.bfloat16 if args.frozen_dtype == "bf16" else torch.float32
    if args.train_text_encoder and not args.t5_ckpt:
        raise SystemExit("--train_text_encoder requires --t5_ckpt")
    dit = from_state_dict(lambda: WanDiT(cfg),
                          load_wan_dit(args.pretrained_ckpt, cfg),
                          torch.float32)
    vae_cfg = VAEConfig(dtype=fdt, param_dtype=fdt)
    vae = from_state_dict(lambda: WanVAE(vae_cfg), load_wan_vae(
        args.vae_ckpt, vae_cfg), fdt).to(dev).requires_grad_(False)
    text_encoder = tokenize = None
    if args.train_text_encoder:
        # the tower runs inside the step with its LoRA merged, its base
        # frozen at --frozen_dtype like every other frozen tower
        t5cfg = T5Config()
        text_encoder = _tower(args.t5_ckpt, lambda: WanT5Encoder(t5cfg), "",
                              "umT5", fdt, dev)
        tokenize = build_tokenize(args.tokenizer, t5cfg.text_len)
    encoders = build_encoders(
        t5=None if args.train_text_encoder else args.t5_ckpt,
        tokenize=(build_tokenize(args.tokenizer, cfg.text_len)
                  if args.t5_ckpt and not args.train_text_encoder else None),
        clip=args.clip_ckpt, text_dim=cfg.text_dim, text_len=cfg.text_len,
        allow_dummy_text=args.allow_dummy_text or args.train_text_encoder,
        weight_dtype=fdt, device=dev)

    videos = sorted(glob.glob(os.path.join(args.data_dir, "videos",
                                           "*.mp4")))
    if not videos:
        raise SystemExit(f"no videos/*.mp4 under {args.data_dir}")
    prompts = {}
    if args.prompts_json:
        with open(args.prompts_json) as f:
            prompts = json.load(f)
    rng = np.random.RandomState(args.seed)
    size = (args.height, args.width)

    def samples():
        while True:
            path = videos[int(rng.randint(len(videos)))]
            name = os.path.splitext(os.path.basename(path))[0]
            try:
                video = load_vism_video(path, args.num_frames, size)
                if args.use_3dgs:
                    render, mask = load_prerendered(path, args.num_frames,
                                                    size)
                    yield prepare_vism_sample(
                        video, prompts.get(name, ""), prerendered=render,
                        prerendered_mask=mask,
                        max_num_frames=args.num_frames, rng=rng, device=dev)
                else:
                    pkl = path.replace("videos", "dt3d_render").replace(
                        ".mp4", "_dt3d_pred.pkl")
                    with open(pkl, "rb") as f:
                        data = pickle.load(f)
                    yield prepare_vism_sample(
                        video, prompts.get(name, ""),
                        coords=np.asarray(data["coords"], np.float32),
                        colors=np.asarray(data["colors"], np.float32),
                        max_num_frames=args.num_frames, rng=rng, device=dev)
            except (OSError, EOFError, KeyError, ValueError,
                    pickle.UnpicklingError) as e:
                print(f"skipping {path}: {e}")

    # the base moves in a box, so that this frame holds no reference and
    # the streamed path can free the host copy (see run_training)
    box = [dit]
    del dit
    run_training(box, vae, encoders.encode_text,
                 prefetch(samples(), depth=4, num_workers=2), args,
                 encode_clip=encoders.encode_clip, text_encoder=text_encoder,
                 tokenize=tokenize, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
