"""Stage-1 control pipeline, 4D-STraG trajectory generation (PyTorch port
of ``more4d_tpu/pipelines/control.py``).

The conditioning ``y`` is [control latents | start-image latents | depth
latents], 48 channels, which with the 16 noise channels makes the 64-channel
DiT input. The text, CLIP and OmniMAE encoders run outside; this class
consumes their embeddings. TeaCache and cfg-skip: see ``base.py``.
"""

from __future__ import annotations

import torch

from .base import BasePipeline


class WanControlPipeline(BasePipeline):

    @torch.no_grad()
    def prepare_conditions(self, latents_shape, control_video=None,
                           start_image=None, depth_image=None):
        """control_video: [B,T,H,W,3] in [-1,1] (the repeated first frame
        for 4D-STraG); start_image: [B,1,H,W,3]; depth_image: [B,1,H,W,3]
        (repeated to T frames before the encode). Returns [B, T', h, w, 32
        or 48]."""
        b, tl, h, w, _ = latents_shape
        z = self.vae.cfg.z_dim
        dev = self.device
        parts = []

        depth_lat = None
        if depth_image is not None:
            t_frames = (tl - 1) * self.vae.cfg.temporal_ratio + 1
            depth_video = depth_image.to(dev).expand(
                (b, t_frames) + tuple(depth_image.shape[2:]))
        if control_video is not None:
            if depth_image is not None:
                # one batch-2b encode of the two static hints: the encoder
                # is per-sample, so stacking gives the two serial encodes
                lat = self.encode_video(torch.cat([control_video.to(dev),
                                                   depth_video]),
                                        static_hint=True)
                parts.append(lat[:b])
                depth_lat = lat[b:]
            else:
                parts.append(self.encode_video(control_video,
                                               static_hint=True))
        else:
            parts.append(torch.zeros((b, tl, h, w, z), device=dev))

        start = torch.zeros((b, tl, h, w, z), device=dev)
        if start_image is not None:
            start[:, :1] = self.encode_video(start_image)
        parts.append(start)

        if depth_image is not None:
            if depth_lat is None:
                depth_lat = self.encode_video(depth_video, static_hint=True)
            parts.append(depth_lat)
        return torch.cat(parts, dim=-1)

    def __call__(self, generator, prompt_embeds, neg_embeds=None,
                 control_video=None, start_image=None, depth_image=None,
                 clip_fea=None, mpm_features=None, num_frames=None,
                 height=None, width=None, output_type="latent",
                 guidance_scale=None):
        """Full stage-1 generation. Returns latents or decoded frames
        ([-1,1] raw for trajectory tensors when output_type='no_normalize',
        [0,1] otherwise)."""
        b = prompt_embeds.shape[0]
        latents = self.prepare_latents(generator, b, num_frames, height,
                                       width)
        y = self.prepare_conditions(latents.shape, control_video,
                                    start_image, depth_image)
        latents = self.denoise(latents, prompt_embeds, neg_embeds, y=y,
                               clip_fea=clip_fea, mpm_features=mpm_features,
                               guidance_scale=guidance_scale)
        if output_type == "latent":
            return latents
        return self.decode_latents(
            latents, normalize_output=(output_type != "no_normalize"))
