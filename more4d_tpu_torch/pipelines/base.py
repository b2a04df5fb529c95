"""Shared denoise-loop machinery for the Wan pipelines (PyTorch port of
``more4d_tpu/pipelines/base.py``).

Each step is one CFG-doubled DiT forward (uncond and cond halves in one
batch) followed by the guidance combine and a sampler step; with
``cfg_skip_ratio`` the last steps run the cond half alone. The loop is a
plain Python loop. TeaCache is not ported yet.
"""

from __future__ import annotations

import math

import torch

from .. import resolve_device
from ..config import PipelineConfig
from ..diffusion import get_scheduler
from ..models.vae_streaming import decode_streamed, encode_streamed
from ..models.wan_dit import WanDiT
from ..models.wan_vae import WanVAE
from ..nn.rope import RopeTables


class BasePipeline:
    """Holds the DiT and the VAE (moved to ``device``) and runs the loop.
    ``device`` defaults to the card and raises if there is none."""

    def __init__(self, dit: WanDiT, vae: WanVAE,
                 config: PipelineConfig = PipelineConfig(), device="cuda"):
        if config.teacache_threshold:
            raise NotImplementedError("TeaCache is not ported to PyTorch "
                                      "yet (teacache_threshold must be 0)")
        self.device = resolve_device(device)
        self.dit = dit.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        self.config = config
        self.scheduler = get_scheduler(config.scheduler,
                                       config.num_inference_steps,
                                       config.shift,
                                       **dict(config.scheduler_kwargs))
        riflex = {}
        if config.riflex_k:
            lt = (config.num_frames - 1) // 4 + 1
            riflex = dict(riflex_k=config.riflex_k, riflex_l_test=lt)
        self.rope_tables = RopeTables.create(dit.cfg.head_dim, **riflex)

    # ---------------- VAE helpers ---------------- #

    @torch.no_grad()
    def encode_video(self, video, static_hint: bool = False):
        """video [B,T,H,W,3] in [-1,1] -> deterministic (mode) latents,
        streamed in input-frame chunks [1, 4, 4, ...]."""
        mu, _ = encode_streamed(
            self.vae, video.to(self.device), static_hint=static_hint,
            latents_per_step=self.config.vae_latents_per_step)
        return mu.float()

    @torch.no_grad()
    def decode_latents(self, latents, normalize_output: bool = True):
        """Latents -> frames, streamed one latent frame at a time. True
        maps to [0, 1]; False returns the raw [-1, 1] decode used for
        trajectory tensors."""
        frames = decode_streamed(
            self.vae, latents.to(self.device),
            latents_per_step=self.config.vae_latents_per_step).float()
        if normalize_output:
            frames = (frames / 2 + 0.5).clamp(0.0, 1.0)
        return frames

    def prepare_latents(self, generator: torch.Generator, batch: int,
                        num_frames=None, height=None, width=None):
        """Initial noise [B, T', h, w, z] drawn from ``generator`` on the
        generator's device."""
        cfgp = self.config
        num_frames = num_frames or cfgp.num_frames
        height = height or cfgp.height
        width = width or cfgp.width
        vcfg = self.vae.cfg
        shape = (batch, (num_frames - 1) // vcfg.temporal_ratio + 1,
                 height // vcfg.spatial_ratio, width // vcfg.spatial_ratio,
                 vcfg.z_dim)
        return torch.randn(shape, generator=generator,
                           device=generator.device,
                           dtype=torch.float32).to(self.device)

    # ---------------- denoise loop ---------------- #

    def _step(self, i, latents, ctx, y, clip, mpm, guidance, cfg_double):
        x_in = torch.cat([latents, latents]) if cfg_double else latents
        t = torch.full((x_in.shape[0],), float(self.scheduler.timesteps[i]),
                       dtype=torch.float32, device=self.device)
        pred = self.dit(x_in, t, ctx, y=y, clip_fea=clip, mpm_features=mpm,
                        rope_tables=self.rope_tables)
        if cfg_double:
            uncond, cond = pred.chunk(2)
            pred = uncond + guidance * (cond - uncond)
        latents, _ = self.scheduler.step(i, latents, pred.float(), ())
        return latents

    @torch.no_grad()
    def denoise(self, latents, prompt_embeds, neg_embeds=None, y=None,
                clip_fea=None, mpm_features=None, guidance_scale=None):
        """Full denoise loop. latents: [B, T', h, w, 16] initial noise;
        prompt/neg embeds: [B, L, text_dim]. Returns final latents."""
        cfgp = self.config
        if guidance_scale is None:
            guidance_scale = cfgp.guidance_scale
        dev = self.device

        def put(a):
            return None if a is None else a.to(dev)

        latents = latents.to(dev, torch.float32)
        prompt_embeds, neg_embeds = put(prompt_embeds), put(neg_embeds)
        y, clip_fea, mpm_features = put(y), put(clip_fea), put(mpm_features)
        do_cfg = guidance_scale > 1.0 and neg_embeds is not None
        n = self.scheduler.num_steps
        n_skip = int(math.ceil(n * cfgp.cfg_skip_ratio)) if do_cfg else 0
        n_cfg = (n - n_skip) if do_cfg else 0

        if n_cfg > 0:
            def dup(a):
                return None if a is None else torch.cat([a, a])

            ctx2 = torch.cat([neg_embeds, prompt_embeds])
            y2, clip2, mpm2 = dup(y), dup(clip_fea), dup(mpm_features)
            for i in range(n_cfg):
                latents = self._step(i, latents, ctx2, y2, clip2, mpm2,
                                     guidance_scale, cfg_double=True)
        for i in range(n_cfg, n):
            latents = self._step(i, latents, prompt_embeds, y, clip_fea,
                                 mpm_features, guidance_scale,
                                 cfg_double=False)
        return latents
