"""The VAE trajectory adaptors' round trip over scene-flow pickles (PyTorch
port of ``scripts/infer_vae.py``, with its flags and defaults).

    python -m more4d_tpu_torch.scripts.infer_vae --video_list list.txt \\
      --vae_ckpt Wan2.1_VAE.pth --encoder_adaptor encoder_prompt.bin \\
      --decoder_adaptor decoder_prompt.bin --output_dir vae_eval/

For each pickle: the normalised trajectories through the encoder adaptor,
the frozen VAE's encode (the posterior mode) and decode, and the decoder
adaptor; L1, RMSE and end-point error per sample into
``vae_eval.jsonl``, and one summary JSON line on stdout. With
``--save_videos`` the original and the reconstruction are rendered side by
side: by the z-buffer projection of ``data/vism.py`` (``--render_type
project``, the default), by the tile splat K4 (``3dgs``), or both.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np
import torch

from .. import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m more4d_tpu_torch.scripts.infer_vae",
        description="VAE trajectory-adaptor round trip")
    p.add_argument("--video_list", required=True)
    p.add_argument("--posfix", default="")
    p.add_argument("--data_root", default=None)
    p.add_argument("--vae_ckpt", required=True)
    p.add_argument("--encoder_adaptor", required=True)
    p.add_argument("--decoder_adaptor", required=True)
    p.add_argument("--output_dir", default="vae_eval")
    p.add_argument("--normalize", default="track_z",
                   choices=["track", "track_first_frame", "track_z",
                            "delta"])
    p.add_argument("--num_frames", type=int, default=17)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--max_samples", type=int, default=16)
    p.add_argument("--save_videos", action="store_true")
    p.add_argument("--render_type", default="project",
                   choices=["project", "3dgs", "both"])
    p.add_argument("--gs_scale", type=float, default=1e-4)
    return p


@torch.no_grad()
def roundtrip(vae, enc, dec, flow: np.ndarray) -> np.ndarray:
    """flow [T, H, W, 3] normalised -> the reconstruction (the posterior
    mode: deterministic)."""
    dev = next(vae.parameters()).device
    pseudo = enc(torch.from_numpy(flow)[None].to(dev)) * 2.0 - 1.0
    mu, _ = vae.encode(pseudo)
    out = dec(vae.decode(mu, clip=False))
    return out[0].float().cpu().numpy()


def evaluate(vae, enc, dec, samples, args, render_fn=None) -> dict:
    """``samples`` yields (name, flow [T, H, W, 3]); at most
    ``args.max_samples`` go through ``roundtrip``. Returns (and prints) the
    summary."""
    from ..utils.metrics import MetricsLogger

    os.makedirs(args.output_dir, exist_ok=True)
    metrics = MetricsLogger(args.output_dir, name="vae_eval")
    l1s, rmses, epes = [], [], []
    for i, (name, flow) in enumerate(samples):
        if i >= args.max_samples:
            break
        recon = roundtrip(vae, enc, dec, flow)
        err = recon - flow
        l1s.append(float(np.abs(err).mean()))
        rmses.append(float(np.sqrt((err ** 2).mean())))
        epes.append(float(np.linalg.norm(err, axis=-1).mean()))
        metrics.log(i, {"l1": l1s[-1], "rmse": rmses[-1], "epe": epes[-1]},
                    prefix=name)
        if render_fn is not None:
            render_fn(name, flow, recon)
    metrics.close()
    summary = {"metric": "vae_adaptor_roundtrip_epe",
               "value": float(np.mean(epes)) if epes else float("nan"),
               "unit": "mean-EPE",
               "extra": {"l1": float(np.mean(l1s)) if l1s else None,
                         "rmse": float(np.mean(rmses)) if rmses else None,
                         "n": len(epes)}}
    print(json.dumps(summary))
    return summary


def build_render_fn(args, device):
    """The side-by-side videos of ``--save_videos``, original left and
    reconstruction right, each frame's cloud pushed 2 m in front of an
    identity camera at half the resolution: ``--render_type project``
    through the z-buffer projection (``data/vism.py``), ``3dgs`` through
    the tile splat (K4), ``both`` writes the two videos."""
    from ..data.vism import project_point_cloud
    from ..geometry import get_intrinsic_matrix
    from ..kernels.gs_splat import gs_render_tiled_video
    from ..utils.artifacts import save_videos_grid

    rh, rw = args.height // 2, args.width // 2
    dev = resolve_device(device)
    off = torch.tensor([0.0, 0.0, 2.0], device=dev)

    def project_pair(flow, recon, colors):
        frames = []
        for f, r in zip(flow, recon):
            a, _ = project_point_cloud(f.reshape(-1, 3) + off, colors, rh,
                                       rw)
            b, _ = project_point_cloud(r.reshape(-1, 3) + off, colors, rh,
                                       rw)
            frames.append(torch.cat([a, b], dim=1))
        return torch.stack(frames)

    def splat(flow, colors):
        intr = get_intrinsic_matrix(rh, rw, device=dev)
        pts = flow.reshape(flow.shape[0], -1, 3)
        exts = torch.eye(4, device=dev).expand(flow.shape[0], 4, 4)
        frames, _ = gs_render_tiled_video(pts + off, colors, exts, intr, rh,
                                          rw, scale=args.gs_scale)
        return frames

    def render_fn(name, flow, recon):
        rs = np.random.RandomState(0)
        colors = torch.from_numpy(rs.rand(flow.shape[1] * flow.shape[2], 3)
                                  .astype(np.float32)).to(dev)
        flow_t = torch.from_numpy(np.asarray(flow, np.float32)).to(dev)
        recon_t = torch.from_numpy(np.asarray(recon, np.float32)).to(dev)
        if args.render_type in ("project", "both"):
            save_videos_grid(
                os.path.join(args.output_dir, f"{name}_roundtrip.mp4"),
                project_pair(flow_t, recon_t, colors)[None], fps=8)
        if args.render_type in ("3dgs", "both"):
            pair = torch.cat([splat(flow_t, colors), splat(recon_t, colors)],
                             dim=2)
            save_videos_grid(
                os.path.join(args.output_dir, f"{name}_roundtrip_gs.mp4"),
                pair.clamp(0, 1)[None], fps=8)

    return render_fn


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    from ..config import VAEConfig
    from ..convert.vae_torch import load_wan_vae
    from ..data.vae_flow import VAEFlowDataset, normalize_vae_target
    from ..models.adaptors import (VAEDecoderAdaptor, VAEEncoderAdaptor,
                                   load_adaptor)
    from ..models.wan_vae import WanVAE
    from ..nn.layers import from_state_dict

    render_fn = build_render_fn(args, dev) if args.save_videos else None
    vae_sd = load_wan_vae(args.vae_ckpt)
    enc_sd, _ = load_adaptor(args.encoder_adaptor, decoder=False)
    dec_sd, vae_ft = load_adaptor(args.decoder_adaptor, decoder=True)
    if vae_ft is not None:
        # a fine-tuned VAE decoder from the adaptor trainer
        vae_sd.update({k: v for k, v in vae_ft.items()
                       if k.startswith(("decoder.", "conv2."))})
    f32 = torch.float32
    vae = from_state_dict(lambda: WanVAE(VAEConfig()), vae_sd, f32).to(dev)
    enc = from_state_dict(VAEEncoderAdaptor, enc_sd, f32).to(dev)
    dec = from_state_dict(VAEDecoderAdaptor, dec_sd, f32).to(dev)

    ds = VAEFlowDataset(args.video_list, args.posfix, args.data_root,
                        args.height, args.width, args.num_frames)

    def samples():
        for i in range(len(ds)):
            try:
                s = ds[i]
            except (OSError, EOFError, ValueError, KeyError,
                    pickle.UnpicklingError) as e:
                print(f"skipping {ds.paths[i]}: {e}")
                continue
            name = os.path.splitext(os.path.basename(ds.paths[i]))[0]
            yield name, normalize_vae_target(s, args.normalize,
                                             num_frames=args.num_frames)

    evaluate(vae, enc, dec, samples(), args, render_fn)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
