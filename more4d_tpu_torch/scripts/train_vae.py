"""VAE trajectory-adaptor training CLI (PyTorch port of
``scripts/train_vae.py``, with its flags and defaults).

    python -m more4d_tpu_torch.scripts.train_vae --video_list list.txt \\
      --vae_ckpt /ckpts/Wan2.1_VAE.pth --output_dir vae_adaptor/

Scene-flow pickles (one video path a line of ``--video_list``) -> one of
the four coordinate normalisations -> the adaptor step (L1 + 1e-6 KL, the
VAE's decoder fine-tuned by default) with the windowed statistical
outlier skip (``train.optim.LossOutlierTracker``) -> checkpoints
(``train/checkpoint.py``: params {'enc', 'dec', 'vae_decoder'}, which the
inference CLIs' ``--encoder_adaptor``/``--decoder_adaptor`` read) and
JSONL metrics.

``main(argv, device)`` is the program; ``run_training`` its loop. The same
``--seed`` gives other adaptor weights and posterior noise than the JAX
CLI (torch's initialisers and a ``torch.Generator``); the sample order
comes from the same numpy ``RandomState``.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m more4d_tpu_torch.scripts.train_vae",
        description="VAE trajectory-adaptor training")
    p.add_argument("--video_list", required=True,
                   help="txt of video paths (scene-flow pickle convention)")
    p.add_argument("--posfix", default="")
    p.add_argument("--data_root", default=None)
    p.add_argument("--vae_ckpt", required=True)
    p.add_argument("--encoder_adaptor", default=None,
                   help="optional torch .bin to initialise from")
    p.add_argument("--decoder_adaptor", default=None)
    p.add_argument("--output_dir", default="vae_adaptor_ckpt")
    p.add_argument("--normalize", default="track_z",
                   choices=["track", "track_first_frame", "track_z",
                            "delta"])
    p.add_argument("--num_frames", type=int, default=17)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--learning_rate", type=float, default=5e-6)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--lr_scheduler", default="constant",
                   choices=["constant", "constant_with_warmup", "linear",
                            "cosine"])
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="reference --gradient_accumulation_steps")
    p.add_argument("--kl_scale", type=float, default=1e-6)
    p.add_argument("--rec_loss", default="l1", choices=["l1", "l2"])
    p.add_argument("--finetune_vae_decoder", action="store_true",
                   default=True)
    p.add_argument("--no_finetune_vae_decoder", dest="finetune_vae_decoder",
                   action="store_false")
    p.add_argument("--max_steps", type=int, default=10000)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--log_steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", action="store_true")
    # the windowed statistical outlier skip
    p.add_argument("--loss_skip_std_multiplier", type=float, default=6.0)
    p.add_argument("--loss_skip_min_samples", type=int, default=20)
    p.add_argument("--loss_skip_absolute_threshold", type=float,
                   default=1e7)
    p.add_argument("--loss_skip_multiplier", type=float, default=10.0)
    p.add_argument("--loss_skip_window", type=int, default=100)
    return p


def run_training(vae, enc, dec, sample_iter, args, device="cuda",
                 timings: Optional[list] = None):
    """The loop, callable with tiny models: ``sample_iter`` yields flow
    targets [T, H, W, 3] (normalised, numpy or tensors). Trains ``enc``,
    ``dec`` and (with --finetune_vae_decoder) the VAE's decoder in place
    and returns their state dicts, {'enc', 'dec'(, 'vae_decoder')}. The
    VAE's stage layers and the adaptors' res blocks run again in the
    backward (gradient checkpointing, always on in a gradient step: 17
    frames of 384x512 in fp32 otherwise keep more activations than an
    80 GB card holds). ``timings``, when given, gets the seconds of each
    step (the device synchronised)."""
    from ..train.checkpoint import CheckpointManager
    from ..train.optim import (GradUpdate, LossOutlierTracker,
                               make_lr_schedule, make_optimizer)
    from ..train.train_vae import (VAEAdaptorTrainConfig, train_step,
                                   trainable_params)
    from ..utils.metrics import MetricsLogger

    dev = resolve_device(device)
    vae, enc, dec = (m.to(dev) for m in (vae, enc, dec))
    accum = max(args.grad_accum_steps, 1)
    tcfg = VAEAdaptorTrainConfig(
        learning_rate=args.learning_rate, kl_scale=args.kl_scale,
        finetune_decoder=args.finetune_vae_decoder, rec_loss=args.rec_loss,
        max_grad_norm=args.max_grad_norm)
    params = trainable_params(enc, dec, vae, tcfg)
    optimizer, scheduler = make_optimizer(
        "adamw", params,
        make_lr_schedule(args.learning_rate,
                         args.lr_scheduler, args.lr_warmup_steps,
                         max(args.max_steps // accum, 1)),
        betas=(args.adam_beta1, args.adam_beta2),
        weight_decay=args.adam_weight_decay,
        eps=args.adam_epsilon)
    # the clip acts on the accumulated mean gradient (the reference clips
    # at the sync step)
    update = GradUpdate(params, optimizer, scheduler, tcfg.max_grad_norm,
                        accum, clip_mean=True)

    def state():
        out = {"enc": enc.state_dict(), "dec": dec.state_dict()}
        if tcfg.finetune_decoder:
            out["vae_decoder"] = {k: v for k, v in vae.state_dict().items()
                                  if k.startswith(("decoder.", "conv2."))}
        return out

    os.makedirs(args.output_dir, exist_ok=True)
    metrics = MetricsLogger(args.output_dir)
    mgr = CheckpointManager(args.output_dir)
    tracker = LossOutlierTracker(
        window=args.loss_skip_window,
        sigma=args.loss_skip_std_multiplier,
        warmup=args.loss_skip_min_samples,
        absolute_threshold=args.loss_skip_absolute_threshold,
        multiplier=args.loss_skip_multiplier)
    generator = torch.Generator(dev).manual_seed(args.seed)
    global_step = 0
    if args.resume and mgr.latest_step() is not None:
        out = mgr.restore(with_extra=True, map_location=dev)
        enc.load_state_dict(out["params"]["enc"])
        dec.load_state_dict(out["params"]["dec"])
        if tcfg.finetune_decoder:
            vae.load_state_dict(out["params"]["vae_decoder"], strict=False)
        update.load_state_dict(out["opt_state"])
        generator.set_state(out["rng"].cpu())
        global_step = (out.get("extra") or {}).get("global_step", 0)

    z_dim, sr, tr = (vae.cfg.z_dim, vae.cfg.spatial_ratio,
                     vae.cfg.temporal_ratio)
    for flow in sample_iter:
        if global_step >= args.max_steps:
            break
        t0 = time.perf_counter()
        flow = torch.as_tensor(flow).to(dev, torch.float32)[None]
        t, h, w = flow.shape[1:4]
        eps = torch.randn((1, (t - 1) // tr + 1, h // sr, w // sr, z_dim),
                          generator=generator, device=dev)
        m = train_step(enc, dec, vae, params, update, tcfg, {"flow": flow},
                       eps, should_skip=tracker.should_skip)
        if m["skipped"]:
            # the update is dropped, the tracking goes on
            metrics.log(global_step + 1, {"skipped_outlier": 1.0,
                                          "loss": m["loss"]}, prefix="train")
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings.append(time.perf_counter() - t0)
        global_step += 1
        if global_step % args.log_steps == 0 or global_step == 1:
            metrics.log(global_step, m, prefix="train")
            print(f"step {global_step}: " + " ".join(
                f"{k}={float(v):.4f}" for k, v in m.items()))
        if global_step % args.checkpointing_steps == 0:
            mgr.save(global_step, state(), opt_state=update.state_dict(),
                     rng=generator.get_state(),
                     extra={"global_step": global_step})
    metrics.close()
    mgr.close()
    return state()


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    from ..config import VAEConfig
    from ..convert.vae_torch import load_wan_vae
    from ..data.prefetch import prefetch
    from ..data.vae_flow import VAEFlowDataset, normalize_vae_target
    from ..models.adaptors import (VAEDecoderAdaptor, VAEEncoderAdaptor,
                                   load_adaptor)
    from ..models.wan_vae import WanVAE
    from ..nn.layers import from_state_dict

    vae = from_state_dict(lambda: WanVAE(VAEConfig()),
                          load_wan_vae(args.vae_ckpt), torch.float32)
    torch.manual_seed(args.seed)        # the adaptors' initialisation
    enc, dec = VAEEncoderAdaptor(), VAEDecoderAdaptor()
    if args.encoder_adaptor:
        enc.load_state_dict(load_adaptor(args.encoder_adaptor,
                                         decoder=False)[0])
    if args.decoder_adaptor:
        dec.load_state_dict(load_adaptor(args.decoder_adaptor,
                                         decoder=True)[0])

    ds = VAEFlowDataset(args.video_list, args.posfix, args.data_root,
                        args.height, args.width, args.num_frames)
    rng = np.random.RandomState(args.seed)

    def samples():
        while True:
            idx = int(rng.randint(len(ds)))
            try:
                yield normalize_vae_target(ds[idx], args.normalize,
                                           num_frames=args.num_frames)
            except (OSError, EOFError, ValueError, KeyError,
                    pickle.UnpicklingError) as e:
                print(f"skipping {ds.paths[idx]}: {e}")

    run_training(vae, enc, dec, prefetch(samples(), depth=4, num_workers=2),
                 args, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
