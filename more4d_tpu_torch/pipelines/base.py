"""The Wan pipelines' shared part (PyTorch port of
``more4d_tpu/pipelines/base.py``): the DiT and the VAE on the device, the
VAE helpers, the initial noise and the denoise request.

The denoise loop and TeaCache live in ``diffusion/loop.py``. The resident
DiT runs it over ``WanDiT.backbone`` with TeaCache's in-loop rule
(``TeaCacheState``); with ``streamed_dit`` (``parallel/offload.StreamedDiT``:
the block weights streamed from pinned host memory) the same loop runs
over ``StreamedDiT.backbone`` with the schedule rule
(``ScheduleTeaCache``), as the JAX package's streamed loop decides it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..config import PipelineConfig
from ..diffusion import get_scheduler, loop
from ..diffusion.loop import ScheduleTeaCache, TeaCacheConfig, TeaCacheState
from ..models.vae_streaming import decode_streamed, encode_streamed
from ..models.wan_dit import WanDiT
from ..models.wan_vae import WanVAE
from ..nn.rope import RopeTables
from ..utils.profiling import spanned


class BasePipeline:
    """Holds the DiT and the VAE (moved to ``device``) and runs the loop.
    ``device`` defaults to the card and raises if there is none.
    ``teacache``: a TeaCacheConfig, or None to compute every step.
    ``streamed_dit``: a ``StreamedDiT`` whose resident part is ``dit``; the
    denoise loop then streams the blocks."""

    def __init__(self, dit: WanDiT, vae: WanVAE,
                 config: PipelineConfig = PipelineConfig(), device="cuda",
                 teacache: Optional[TeaCacheConfig] = None,
                 streamed_dit=None):
        self.device = resolve_device(device)
        self.teacache = teacache
        self.streamed_dit = streamed_dit
        # the last denoise loop's TeaCache rule (its log holds the
        # calc/replay sequence), None without TeaCache
        self.teacache_state = None
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

    def _forward(self, x_in, t, ctx, y, clip, mpm, tc):
        return loop.dit_forward(self.dit, self.dit.backbone, self.rope_tables,
                                x_in, t, ctx, y, clip, mpm, tc)

    def _step(self, i, latents, sched_state, ctx, y, clip, mpm, guidance,
              cfg_double, tc):
        return loop.sampler_step(self._forward, self.scheduler, i, latents,
                                 sched_state, ctx, y, clip, mpm, guidance,
                                 cfg_double, tc)

    @spanned("more4d.denoise")
    @torch.no_grad()
    def denoise(self, latents, prompt_embeds, neg_embeds=None, y=None,
                clip_fea=None, mpm_features=None, guidance_scale=None):
        """Full denoise loop. latents: [B, T', h, w, 16] initial noise;
        prompt/neg embeds: [B, L, text_dim]. Returns final latents."""
        if guidance_scale is None:
            guidance_scale = self.config.guidance_scale
        kw = dict(neg_embeds=neg_embeds, y=y, clip_fea=clip_fea,
                  mpm_features=mpm_features, guidance_scale=guidance_scale,
                  cfg_skip_ratio=self.config.cfg_skip_ratio)
        tc = self.teacache
        if self.streamed_dit is not None:
            rule = None
            if tc is not None:
                rule = ScheduleTeaCache(tc.coefficients, tc.rel_l1_thresh,
                                        tc.num_skip_start_steps)
                rule.offload = tc.offload_residual
            self.teacache_state = rule
            return self.streamed_dit.denoise(self.scheduler, latents,
                                             prompt_embeds, teacache=rule,
                                             **kw)
        self.teacache_state = None if tc is None else TeaCacheState(tc)
        return loop.denoise(self.dit, self._step, self.scheduler, self.device,
                            latents, prompt_embeds,
                            teacache=self.teacache_state, **kw)
